// K11: the NTT family (ntt, intt, coset_ntt, coset_intt) of (R, n, 16)
// Montgomery rows, n = 2^k, 1 <= k <= 18, natural order in and out.
//
// Replaces no Pallas kernel: the JAX package compiles the transform into
// one XLA program, taiga_tpu/ops/ntt.py::_ntt_fixed_jit (:120-140, the
// constant-geometry Pease stages, a bit-reversal gather and the n^-1
// scale), and the coset forms add ::_coset_scale_jit (:252). The Pease
// form is there because TPU gathers are slow; it is not carried over.
//
// Four-step split: n = n1 n2 (n1 = 2^ceil(k/2), n2 = 2^floor(k/2), each at
// most 2^9), two launches of one pass kernel; k <= 10 is one launch. With
// j = j2 + n2 j1 and k = k1 + n1 k2,
//   X[k1 + n1 k2] = sum_j2 w_n2^(j2 k2) [w^(j2 k1) sum_j1 x[j2 + n2 j1] w_n1^(j1 k1)].
// Pass 1 runs, for each column j2, the n1-point transform over x[j2 + n2
// j1] (stride n2: each element is 64 B, two whole 32-byte sectors, so the
// strided gather wastes no bytes), multiplies by w^(j2 k1) and writes Y[j2
// + n2 k1] to a packed scratch (32 B an element). Pass 2 runs the n2-point
// transform over each contiguous row k1 of Y and stores X[k1 + n1 k2]: the
// transpose is its store index.
//
// A pass: each line's transform is the radix-2 decimation in frequency
// (natural order in, bit-reversed out; the reversal is the store's index).
// A block loads its lines into shared memory (word-major, 8 planes, index
// i at i + i / 32), with the line transform's twiddles w_m^e, e < m / 2.
// Then the stages run in groups of r = log2 R: a thread takes R elements
// of a line into registers (R = 4 or 2; in the group over the stages of
// position bits [b, b + r), the R elements whose positions differ only in
// those bits), runs the group's stages on them with no barrier, and writes
// them back: a barrier a group, where a stage a barrier went before. The
// caller picks R (ff_kernels.ntt_radix_log): radix 4, which halves the
// barriers and gives each stage two independent products a thread, for a
// wide call on rows nonzero only in their first n / 8 (its first group
// skips the butterflies of two zeros, below); radix 2, which keeps twice
// the threads, for the rest: on dense rows it measured faster at every
// shape of the prover. Radix 8
// measured slower at every shape of the prover (163 registers, too few
// warps an SM) and is not built. The block then stores its lines,
// neighbouring threads on neighbouring output positions.
//
// What bounds it: the multiply-adds of the Montgomery products. A product
// is 8 rows of CIOS; fe_mul_pasta (csrc/field.cuh) writes the reduction
// row for the Pasta moduli's words, 11 wide products a row where the
// generic one has 17, in 64-bit sums where a PTX carry chain costs an IMAD
// and an IADD3 for each half product. The kernel runs near the card's rate for these
// products, so its time follows their count.
//
// Zero padding: the input holds a row's first `nonzero` elements and the
// rest read as zero (the prover's extension, to_ext, pads n / 8
// coefficients to n). Pass 1 (or the one pass) loads only positions below
// it. When nonzero <= n / 8, a line's first m / 8 positions hold its
// nonzero elements: at radix 4, the first group's thread c holds one
// nonzero element when c < m / 8 and none otherwise, and skips the
// butterflies of two zeros (3 products, or none, where 4 were), and the
// block loads only those positions.
//
// Fusions: the forward coset's g^i scales each element as pass 1 loads it;
// the inverse's n^-1 (with coset_intt's g^-i folded into one table on the
// host) scales each element as the last pass stores it. Twiddles come from
// one compact table of w^e, e < n/2 (w^(n/2) = -1 gives the rest), 32 B an
// entry, built on the host once per (k, field, direction) and cached on
// the device; a pass reads its lines' twiddles at stride n / m.
//
// Layouts: the input is read as four 16-byte vectors an element (the
// module-boundary layout of ops/limbs.py) through a row and an element
// stride, so a moved axis (ops/ntt.py::ntt_mesh) is read in place; the
// output is contiguous (R, n, 16).
//
// Bound: operations. The function needs, per row, k n / 2 - (n - 1)
// butterfly products (a radix-2 transform less its twiddles of 1; fewer on
// zero-padded inputs) plus n per scale, against 128 B an element moved
// once: 13-17 32-bit multiply-adds a byte at k = 16 (264 a product),
// against the card's balance of 5. The kernel does a pass's butterflies
// but those of its last stage (twiddle 1), and n for the inter-pass
// twiddle: 9 products an element for a dense coset transform at k = 16,
// 7.5 at to_ext's n / 8, where the function needs 6.5. Values are
// canonical and products exact, so any correct transform gives the
// reference's limbs bit for bit.

#include "field.cuh"

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::kWords;
using taiga::fe_mul_pasta;
using taiga::load_limbs;
using taiga::load_packed;
using taiga::store_limbs;
using taiga::store_packed;

constexpr int kMaxLog = 10;               // the longest line a block holds: 2^10 elements
constexpr int kMaxK = 18;                 // the largest domain: two passes of 2^9
constexpr int kBlockLog = 7;              // 128 threads a block, more where a line needs them
constexpr int kMinThreadsLog = 5;         // fewer lines a block, down to a warp, to fill the card
constexpr int64_t kWantBlocks = 2 * 132;  // blocks a launch aims for: two an SM of the H100
// The most shared memory a block takes: 2^10 elements and 2^9 twiddles.
constexpr int kMaxSmem = kWords * ((1 << kMaxLog) + (1 << (kMaxLog - 5)) + (1 << (kMaxLog - 1))) * 4;

struct Pass {
  const uint32_t* in;    // limbs: row r, position pos at in + r in_rs + pos in_es (words); packed: (R, n, 8)
  uint32_t* out;         // limbs: (R, n, 16); packed: (R, n, 8)
  const uint32_t* tw;    // w^e for e < n / 2, packed
  const uint32_t* pre;   // scale at load by position (packed, n entries), or null
  const uint32_t* post;  // scale at store: post[pos post_step] (packed), or null
  int64_t in_rs, in_es;
  int64_t n;
  int64_t in_line, in_elem;    // input position of (line, j): line in_line + j in_elem
  int64_t out_line, out_elem;  // output position of (line, k)
  int64_t nonzero;             // input positions at or above it read as zero
  int64_t total_lines;         // R 2^lines_log
  int lines_log;               // lines a row
  int m_log, g_log;            // 2^m_log elements a line, 2^g_log lines a block
  int twiddle;                 // multiply output (line, k) by w^(line k)
  int post_step;               // 0: one scale for every position; 1: one a position
};

// A block's element i in shared memory: plane w (of 8) at w Ep + i + i / 32.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

__device__ __forceinline__ Fe s_get(const uint32_t* s, int ep, int i) {
  const int o = slot(i);
  Fe r;
#pragma unroll
  for (int w = 0; w < kWords; w++) r.w[w] = s[w * ep + o];
  return r;
}

__device__ __forceinline__ void s_put(uint32_t* s, int ep, int i, const Fe& a) {
  const int o = slot(i);
#pragma unroll
  for (int w = 0; w < kWords; w++) s[w * ep + o] = a.w[w];
}

// The line transform's twiddle w_m^e from shared memory (plane w at w half).
__device__ __forceinline__ Fe tw_get(const uint32_t* st, int half, int e) {
  Fe r;
#pragma unroll
  for (int w = 0; w < kWords; w++) r.w[w] = st[w * half + e];
  return r;
}

// w^e for 0 <= e < n from the table of e < n / 2: w^(e + n/2) = -w^e.
__device__ __forceinline__ Fe omega_pow(const uint32_t* tw, int64_t e, int64_t half,
                                        const FieldConsts& F) {
  if (e < half) return load_packed(tw + e * kWords);
  return taiga::fe_sub(taiga::fe_zero(), load_packed(tw + (e - half) * kWords), F);
}

// The line position of a thread's element j in the group over position bits
// [base, base + LOGR): c's low base bits below them, its other bits above.
template <int LOGR>
__device__ __forceinline__ int group_pos(int j, int c, int base) {
  return ((c >> base) << (base + LOGR)) | (j << base) | (c & ((1 << base) - 1));
}

// The decimation-in-frequency stages q in [base, q_hi) of the group over
// position bits [base, base + LOGR) on a thread's elements: stage q pairs
// positions (i, i + 2^q) in blocks of 2^(q+1) into (u + v, (u - v)
// w_(2^(q+1))^(i mod 2^q)), the twiddle w_m^((i mod 2^q) m / 2^(q+1)).
template <int LOGR>
__device__ __forceinline__ void dif_stages(Fe (&x)[1 << LOGR], int base, int q_hi, int c,
                                           int m_log, const uint32_t* st, int half,
                                           const FieldConsts& F) {
  const int c_low = c & ((1 << base) - 1);
#pragma unroll
  for (int b = LOGR - 1; b >= 0; b--) {
    const int q = base + b;
    if (q >= q_hi) continue;
#pragma unroll
    for (int j = 0; j < (1 << LOGR); j++) {
      if (j & (1 << b)) continue;
      const int jp = j | (1 << b);
      const Fe u = x[j], v = x[jp];
      x[j] = taiga::fe_add(u, v, F);
      Fe d = taiga::fe_sub(u, v, F);
      if (q > 0) {
        const int e = (((j & ((1 << b) - 1)) << base) | c_low) << (m_log - 1 - q);
        d = fe_mul_pasta(d, tw_get(st, half, e), F);
      }
      x[jp] = d;
    }
  }
}

// The first group at radix 4 when only the line's first m / 8 positions
// may be nonzero (m >= 8): a thread's elements sit at c + j m / 4, so only
// x[0], and only for c < m / 8, is nonzero. The stages m_log - 1 and - 2 of
// dif_stages less every butterfly of two zeros (u + 0 = u and u - 0 = u):
// 3 products, not 4, on the threads with c < m / 8 and none on the rest.
__device__ __forceinline__ void dif_first_sparse(Fe (&x)[4], int c, int m_log,
                                                 const uint32_t* st, int half,
                                                 const FieldConsts& F) {
  if (c >= (1 << (m_log - 3))) return;
  x[2] = fe_mul_pasta(x[0], tw_get(st, half, c), F);
  const Fe t0 = tw_get(st, half, c << 1);
  x[1] = fe_mul_pasta(x[0], t0, F);
  x[3] = fe_mul_pasta(x[2], t0, F);
}

template <int LOGR, bool kSparse, bool kInPacked, bool kOutPacked>
__global__ void __launch_bounds__(LOGR == 1 ? 512 : 256) k_ntt_pass(Pass P, int field) {
  extern __shared__ uint32_t smem[];
  constexpr int kR = 1 << LOGR;
  const FieldConsts F = kFields[field];
  const int m_log = P.m_log, g_log = P.g_log, tl = m_log - LOGR;  // 2^tl threads a line
  const int m = 1 << m_log, E = m << g_log, ep = E + (E >> 5), half = m >> 1;
  uint32_t* sd = smem;
  uint32_t* st = smem + kWords * ep;
  const int64_t line0 = (int64_t)blockIdx.x << g_log;
  const int64_t line_mask = (1LL << P.lines_log) - 1;

  // the line transform's twiddles, w_m^e = w^(e n / m) for e < m / 2
  for (int e = threadIdx.x; e < half; e += blockDim.x) {
    const Fe t = load_packed(P.tw + (int64_t)e * (P.n >> m_log) * kWords);
#pragma unroll
    for (int w = 0; w < kWords; w++) st[w * half + e] = t.w[w];
  }

  // load into shared memory: neighbouring threads on neighbouring input
  // positions (lines, when the lines are neighbouring columns; else a
  // line's elements); with kSparse only each line's first m / 8 positions
  const int jn_log = kSparse ? m_log - 3 : m_log;
  const bool lines_in = P.in_line == 1;
#pragma unroll 1
  for (int q = threadIdx.x; q < (1 << (jn_log + g_log)); q += blockDim.x) {
    const int l = lines_in ? (q & ((1 << g_log) - 1)) : (q >> jn_log);
    const int j = lines_in ? (q >> g_log) : (q & ((1 << jn_log) - 1));
    const int64_t gl = line0 + l;
    Fe x = taiga::fe_zero();
    const int64_t ip = (gl & line_mask) * P.in_line + (int64_t)j * P.in_elem;
    if (gl < P.total_lines && ip < P.nonzero) {
      const int64_t row = gl >> P.lines_log;
      x = kInPacked ? load_packed(P.in + (row * P.n + ip) * kWords)
                    : load_limbs(P.in + row * P.in_rs + ip * P.in_es);
      if (P.pre) x = fe_mul_pasta(x, load_packed(P.pre + ip * kWords), F);
    }
    s_put(sd, ep, (l << m_log) + j, x);
  }
  __syncthreads();

  // the groups of stages, each on R elements a thread in registers: read
  // them, run the group's stages, write them back. A thread writes only
  // the positions it read in its group, which no other thread reads in it,
  // so one barrier a group suffices.
  const int l = threadIdx.x >> tl, c = threadIdx.x & ((1 << tl) - 1), lb = l << m_log;
#pragma unroll 1
  for (int hi = m_log; hi > 0;) {
    const int base = hi > LOGR ? hi - LOGR : 0;
    Fe x[kR];
    if constexpr (kSparse) {
      if (hi == m_log) {
#pragma unroll
        for (int j = 0; j < kR; j++) x[j] = taiga::fe_zero();
        if (c < (1 << (m_log - 3))) x[0] = s_get(sd, ep, lb | group_pos<LOGR>(0, c, base));
        dif_first_sparse(x, c, m_log, st, half, F);
      }
    }
    if (!kSparse || hi < m_log) {
#pragma unroll
      for (int j = 0; j < kR; j++) x[j] = s_get(sd, ep, lb | group_pos<LOGR>(j, c, base));
      dif_stages<LOGR>(x, base, hi, c, m_log, st, half, F);
    }
#pragma unroll
    for (int j = 0; j < kR; j++) s_put(sd, ep, lb | group_pos<LOGR>(j, c, base), x[j]);
    __syncthreads();
    hi = base;
  }

  // store: output k of a line sits at its bit reversal
  const bool lines_out = P.out_line == 1;
#pragma unroll 1
  for (int q = threadIdx.x; q < E; q += blockDim.x) {
    int ll, k, i;
    if (lines_out) {
      ll = q & ((1 << g_log) - 1);
      k = q >> g_log;
      i = __brev(k) >> (32 - m_log);
    } else {  // a line's elements in shared-memory order, k scattered
      ll = q >> m_log;
      i = q & (m - 1);
      k = __brev(i) >> (32 - m_log);
    }
    const int64_t gl = line0 + ll;
    if (gl >= P.total_lines) continue;
    const int64_t row = gl >> P.lines_log, line = gl & line_mask;
    Fe x = s_get(sd, ep, (ll << m_log) + i);
    if (P.twiddle) x = fe_mul_pasta(x, omega_pow(P.tw, line * k, P.n >> 1, F), F);
    const int64_t pos = line * P.out_line + (int64_t)k * P.out_elem;
    if (P.post) x = fe_mul_pasta(x, load_packed(P.post + pos * P.post_step * kWords), F);
    if (kOutPacked)
      store_packed(P.out + (row * P.n + pos) * kWords, x);
    else
      store_limbs(P.out + (row * P.n + pos) * taiga::kLimbs, x);
  }
}

// Lines a block: 128 threads' worth (or one line, where it needs more),
// fewer while the launch has under kWantBlocks blocks and a block keeps a
// warp.
int lines_log(int tl, int64_t total_lines) {
  int g_log = tl >= kBlockLog ? 0 : kBlockLog - tl;
  while (g_log > 0 && tl + g_log > kMinThreadsLog && (total_lines >> g_log) < kWantBlocks)
    g_log--;
  return g_log;
}

template <int LOGR, bool kSparse, bool kInPacked, bool kOutPacked>
int launch(Pass P, int field, cudaStream_t stream) {
  const auto kernel = k_ntt_pass<LOGR, kSparse, kInPacked, kOutPacked>;
  const int tl = P.m_log - LOGR;
  P.g_log = lines_log(tl, P.total_lines);
  const int64_t blocks = (P.total_lines + (1LL << P.g_log) - 1) >> P.g_log;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int E = 1 << (P.m_log + P.g_log);
  const size_t smem = (size_t)kWords * (E + (E >> 5) + (1 << (P.m_log - 1))) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // a line of 2^10 with its twiddles: 50,176 B
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(unsigned)blocks, 1 << (tl + P.g_log), smem, stream>>>(P, field);
  return (int)cudaGetLastError();
}

// A pass at radix 2^LOGR: reading limbs (the input) or the packed scratch,
// writing limbs (the output) or the scratch. The input pass takes the
// sparse first group when only the first n / 8 positions may be nonzero.
template <int LOGR>
int launch_radix(Pass P, bool in_packed, bool out_packed, int field, cudaStream_t stream) {
  if (in_packed) return launch<LOGR, false, true, false>(P, field, stream);
  if constexpr (LOGR == 2) {
    if (8 * P.nonzero <= P.n && P.m_log >= 3)
      return out_packed ? launch<LOGR, true, false, true>(P, field, stream)
                        : launch<LOGR, true, false, false>(P, field, stream);
  }
  return out_packed ? launch<LOGR, false, false, true>(P, field, stream)
                    : launch<LOGR, false, false, false>(P, field, stream);
}

int run_pass(Pass P, int logr, bool in_packed, bool out_packed, int field, cudaStream_t stream) {
  if (logr == 2 && P.m_log >= 2) return launch_radix<2>(P, in_packed, out_packed, field, stream);
  return launch_radix<1>(P, in_packed, out_packed, field, stream);
}

}  // namespace

// out (R, n, 16) = the transform of the R rows of `in`, each holding its
// first `nonzero` elements (element (r, i) at in + r in_rs + i in_es
// words, 16 limbs; in_rs, in_es multiples of 4 and `in` 16-byte aligned),
// the rest zero. tw: w^e, e < n / 2 (w^-e for an inverse); pre: g^i (n
// entries) or null; post: n^-1 (post_step 0) or n^-1 g^-i (post_step 1, n
// entries) or null; all packed, 8 words an entry. scratch (R, n, 8) words,
// used when k > 10. logr: log2 of the radix (elements a thread), 1 or 2.
extern "C" int taiga_ntt(const uint32_t* in, int64_t in_rs, int64_t in_es, int64_t nonzero,
                         uint32_t* out, uint32_t* scratch, const uint32_t* tw, const uint32_t* pre,
                         const uint32_t* post, int post_step, int64_t R, int k, int logr,
                         int field, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (k < 1 || k > kMaxK || field < 0 || field > 1 || logr < 1 || logr > 2)
    return (int)cudaErrorInvalidValue;
  const int64_t n = 1LL << k;
  if (nonzero < 1 || nonzero > n) return (int)cudaErrorInvalidValue;
  Pass P{};
  P.tw = tw;
  P.n = n;
  if (k <= kMaxLog) {  // one line a row
    P.in = in;
    P.out = out;
    P.pre = pre;
    P.post = post;
    P.in_rs = in_rs;
    P.in_es = in_es;
    P.in_elem = P.out_elem = 1;
    P.nonzero = nonzero;
    P.total_lines = R;
    P.m_log = k;
    P.post_step = post_step;
    return run_pass(P, logr, false, false, field, stream);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int a = (k + 1) / 2, b = k - a;
  const int64_t n1 = 1LL << a, n2 = 1LL << b;
  // pass 1: column j2 (a line), its elements j1 at j2 + n2 j1; out at j2 + n2 k1
  Pass P1 = P;
  P1.in = in;
  P1.out = scratch;
  P1.pre = pre;
  P1.in_rs = in_rs;
  P1.in_es = in_es;
  P1.in_line = P1.out_line = 1;
  P1.in_elem = P1.out_elem = n2;
  P1.nonzero = nonzero;
  P1.lines_log = b;
  P1.total_lines = R << b;
  P1.m_log = a;
  P1.twiddle = 1;
  int rc = run_pass(P1, logr, false, true, field, stream);
  if (rc != 0) return rc;
  // pass 2: row k1 (a line) of n2 contiguous elements; out k2 at k1 + n1 k2
  Pass P2 = P;
  P2.in = scratch;
  P2.out = out;
  P2.post = post;
  P2.in_line = n2;
  P2.in_elem = 1;
  P2.out_line = 1;
  P2.out_elem = n1;
  P2.nonzero = n;
  P2.lines_log = a;
  P2.total_lines = R << a;
  P2.m_log = b;
  P2.post_step = post_step;
  return run_pass(P2, logr, true, false, field, stream);
}
