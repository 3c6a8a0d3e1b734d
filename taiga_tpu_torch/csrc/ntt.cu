// K11: the NTT family (ntt, intt, coset_ntt, coset_intt) of (R, n, 16)
// Montgomery rows, n = 2^k, 1 <= k <= 18, natural order in and out.
//
// Replaces no Pallas kernel: the JAX package compiles the transform into
// one XLA program, taiga_tpu/ops/ntt.py::_ntt_fixed_jit (:120-140, the
// constant-geometry Pease stages, a bit-reversal gather and the n^-1
// scale), and the coset forms add ::_coset_scale_jit (:252). The Pease
// form is there because TPU gathers are slow; it is not carried over.
//
// Design: a four-step split n = n1 n2 (n1 = 2^ceil(k/2), n2 = 2^floor(k/2),
// each at most 2^9 on the path, 2^10 at most in a block), two launches of
// one pass kernel; k <= 10 is one launch. With j = j2 + n2 j1 and
// k = k1 + n1 k2,
//   X[k1 + n1 k2] = sum_j2 w_n2^(j2 k2) [w^(j2 k1) sum_j1 x[j2 + n2 j1] w_n1^(j1 k1)].
// Pass 1 runs, for each column j2, the n1-point transform over x[j2 + n2
// j1] (stride n2: each element is 64 B, two whole 32-byte sectors, so the
// strided gather wastes no bytes; a block takes neighbouring columns, so a
// warp reads neighbouring elements), multiplies by w^(j2 k1) and writes
// Y[j2 + n2 k1] to a packed scratch (32 B an element). Pass 2 runs the
// n2-point transform over each contiguous row k1 of Y and stores X[k1 + n1
// k2]: the transpose is its store index. Each line's transform is the
// radix-2 decimation in frequency in shared memory (natural order in,
// bit-reversed out; the reversal is the store's read index), a block
// barrier between stages, one thread a butterfly.
//
// Fusions: the forward coset's g^i scales each element as pass 1 loads it;
// the inverse's n^-1 (with coset_intt's g^-i folded into one table on the
// host) scales each element as the last pass stores it. Twiddles come from
// one compact table of w^e, e < n/2 (w^(n/2) = -1 gives the rest), 32 B an
// entry, built on the host once per (k, field, direction) and cached on
// the device.
//
// Layouts: the input is read as four 16-byte vectors an element (the
// module-boundary layout of ops/limbs.py) through a row and an element
// stride, so a moved axis (ops/ntt.py::ntt_mesh) is read in place; the
// output is contiguous (R, n, 16). Shared memory holds a block's elements
// word-major (8 planes), an index i stored at i + i / 32: the butterflies'
// pairs, the neighbouring columns of a load and the bit-reversed reads of a
// store then fall on distinct banks at a block of 1,024 elements.
//
// Bound: operations. The function needs, per row, k n / 2 - (n - 1)
// butterfly products (a radix-2 transform less its twiddles of 1; fewer on
// zero-padded inputs) plus n per scale, against 128 B an element moved
// once: 13-17 32-bit multiply-adds a byte at k = 16 (264 a product),
// against the card's balance of 5.
// The kernel does k n / 2 for k > 10: each pass's butterflies but those of
// its last stage, whose twiddle is 1, and n for the inter-pass twiddle.
// Values are canonical and products exact, so any correct transform gives
// the reference's limbs bit for bit.

#include "field.cuh"

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::kWords;
using taiga::load_limbs;
using taiga::load_packed;
using taiga::store_limbs;
using taiga::store_packed;

constexpr int kThreads = 128;            // threads a block
constexpr int kMaxLog = 10;              // the longest line a block holds: 2^10 elements
constexpr int kMaxK = 18;                // the largest domain: two passes of 2^9
constexpr int64_t kWantBlocks = 2 * 132;  // blocks a launch aims for: two an SM of the H100

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
  int64_t blocks_per_row;
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

// w^e for 0 <= e < n from the table of e < n / 2: w^(e + n/2) = -w^e.
__device__ __forceinline__ Fe omega_pow(const uint32_t* tw, int64_t e, int64_t half,
                                        const FieldConsts& F) {
  if (e < half) return load_packed(tw + e * kWords);
  return taiga::fe_sub(taiga::fe_zero(), load_packed(tw + (e - half) * kWords), F);
}

template <bool kInPacked, bool kOutPacked>
__global__ void __launch_bounds__(kThreads) k_ntt_pass(Pass P, int field) {
  extern __shared__ uint32_t s[];
  const FieldConsts F = kFields[field];
  const int m_log = P.m_log, g_log = P.g_log;
  const int m = 1 << m_log, E = m << g_log, ep = E + (E >> 5);
  const int64_t row = blockIdx.x / P.blocks_per_row;
  const int64_t line0 = (blockIdx.x % P.blocks_per_row) << g_log;

  // load: neighbouring threads on neighbouring positions (lines, when the
  // lines are neighbouring columns; else a line's elements)
  const bool lines_in = P.in_line == 1;
#pragma unroll 1
  for (int q = threadIdx.x; q < E; q += kThreads) {
    const int l = lines_in ? (q & ((1 << g_log) - 1)) : (q >> m_log);
    const int j = lines_in ? (q >> g_log) : (q & (m - 1));
    const int64_t pos = (line0 + l) * P.in_line + (int64_t)j * P.in_elem;
    Fe x = kInPacked ? load_packed(P.in + (row * P.n + pos) * kWords)
                     : load_limbs(P.in + row * P.in_rs + pos * P.in_es);
    if (P.pre) x = taiga::fe_mul(x, load_packed(P.pre + pos * kWords), F);
    s_put(s, ep, (l << m_log) + j, x);
  }
  __syncthreads();

  // decimation in frequency: stage h pairs (i, i + h) in blocks of 2h,
  // (u + v, (u - v) w_m^(t m / 2h)) with w_m^(t m / 2h) = w^(t n / 2h)
#pragma unroll 1
  for (int hl = m_log - 1; hl >= 0; hl--) {
    const int h = 1 << hl;
    const int64_t tstep = P.n >> (hl + 1);
#pragma unroll 1
    for (int b = threadIdx.x; b < (E >> 1); b += kThreads) {
      const int t = b & (h - 1);
      const int i = ((b >> hl) << (hl + 1)) | t;
      const Fe u = s_get(s, ep, i), v = s_get(s, ep, i + h);
      Fe d = taiga::fe_sub(u, v, F);
      if (hl > 0) d = taiga::fe_mul(d, load_packed(P.tw + t * tstep * kWords), F);
      s_put(s, ep, i, taiga::fe_add(u, v, F));
      s_put(s, ep, i + h, d);
    }
    __syncthreads();
  }

  // store: output k of a line sits at its bit reversal
  const bool lines_out = P.out_line == 1;
#pragma unroll 1
  for (int q = threadIdx.x; q < E; q += kThreads) {
    int l, k, i;
    if (lines_out) {
      l = q & ((1 << g_log) - 1);
      k = q >> g_log;
      i = __brev(k) >> (32 - m_log);
    } else {  // a line's elements in shared-memory order, k scattered
      l = q >> m_log;
      i = q & (m - 1);
      k = __brev(i) >> (32 - m_log);
    }
    Fe x = s_get(s, ep, (l << m_log) + i);
    const int64_t line = line0 + l;
    if (P.twiddle) x = taiga::fe_mul(x, omega_pow(P.tw, line * k, P.n >> 1, F), F);
    const int64_t pos = line * P.out_line + (int64_t)k * P.out_elem;
    if (P.post) x = taiga::fe_mul(x, load_packed(P.post + pos * P.post_step * kWords), F);
    if (kOutPacked)
      store_packed(P.out + (row * P.n + pos) * kWords, x);
    else
      store_limbs(P.out + (row * P.n + pos) * taiga::kLimbs, x);
  }
}

// Lines a block: as many as fit 2^kMaxLog elements, fewer while the launch
// has under kWantBlocks blocks and a block keeps at least 256 elements.
int lines_log(int m_log, int64_t lines, int64_t R) {
  int g_log = kMaxLog - m_log;
  while ((1LL << g_log) > lines) g_log--;
  while (g_log > 0 && m_log + g_log > 8 && R * (lines >> g_log) < kWantBlocks) g_log--;
  return g_log;
}

template <bool kInPacked, bool kOutPacked>
int launch(Pass P, int64_t lines, int64_t R, int field, cudaStream_t stream) {
  P.g_log = lines_log(P.m_log, lines, R);
  P.blocks_per_row = lines >> P.g_log;
  const int64_t blocks = R * P.blocks_per_row;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int E = 1 << (P.m_log + P.g_log);
  const size_t smem = (size_t)kWords * (E + (E >> 5)) * sizeof(uint32_t);
  k_ntt_pass<kInPacked, kOutPacked><<<(unsigned)blocks, kThreads, smem, stream>>>(P, field);
  return (int)cudaGetLastError();
}

}  // namespace

// out (R, n, 16) = the transform of the R rows of `in` (element (r, i) at
// in + r in_rs + i in_es words, 16 limbs; in_rs, in_es multiples of 4 and
// `in` 16-byte aligned). tw: w^e, e < n / 2 (w^-e for an inverse); pre:
// g^i (n entries) or null; post: n^-1 (post_step 0) or n^-1 g^-i
// (post_step 1, n entries) or null; all packed, 8 words an entry. scratch
// (R, n, 8) words, used when k > 10.
extern "C" int taiga_ntt(const uint32_t* in, int64_t in_rs, int64_t in_es, uint32_t* out,
                         uint32_t* scratch, const uint32_t* tw, const uint32_t* pre,
                         const uint32_t* post, int post_step, int64_t R, int k, int field,
                         cudaStream_t stream) {
  if (R <= 0) return 0;
  if (k < 1 || k > kMaxK || field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  const int64_t n = 1LL << k;
  if (k <= kMaxLog) {
    const Pass P{in, out, tw, pre, post, in_rs, in_es, n, 0, 1, 0, 1, 1, k, 0, 0, post_step};
    return launch<false, false>(P, 1, R, field, stream);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int a = (k + 1) / 2, b = k - a;
  const int64_t n1 = 1LL << a, n2 = 1LL << b;
  // pass 1: column j2 (a line), its elements j1 at j2 + n2 j1; out at j2 + n2 k1
  const Pass P1{in, scratch, tw, pre, nullptr, in_rs, in_es, n, 1, n2, 1, n2, 1, a, 0, 1, 0};
  int rc = launch<false, true>(P1, n2, R, field, stream);
  if (rc != 0) return rc;
  // pass 2: row k1 (a line) of n2 contiguous elements; out k2 at k1 + n1 k2
  const Pass P2{scratch, out, tw, nullptr, post, 0, 0, n, n2, 1, 1, n1, 1, b, 0, 0, post_step};
  return launch<true, false>(P2, n1, R, field, stream);
}
