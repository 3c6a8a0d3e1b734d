// The lookup argument's permuted pair: K15 permute_pairs (halo2's
// lookup::permute_expression_pair) for every lookup of a batch at once.
//
// Replaces no Pallas kernel: the JAX package compiles it into one XLA
// program, taiga_tpu/ops/lookup_sort.py::permute_pairs_device (:112-121,
// with _permute_one, :48-109): lax.sort over 8 packed key words, a merge
// sort of [S | distinct(A')] with a tag, a stable compaction and a gather.
// Run eagerly, that is 8-9 passes of a stable argsort a sort, a Python loop
// over the lookups and four eager Montgomery conversions: some 2,400
// dispatched torch ops for the 5 lookups of one compliance proof.
//
// What it computes, by value (so any correct algorithm gives the
// reference's limbs, on a failing lookup too), over the first u rows of
// each of R rows (R = proofs x lookups) of A and S, Montgomery in and out:
//   A' = A sorted in integer order of the plain values;
//   S'[i] = A'[i] where i starts a run of A'; elsewhere the leftovers in
//          ascending order, the leftovers being S less one copy of each
//          distinct A value that S holds;
//   ok = every distinct A value is in S.
// The leftovers always outnumber the positions that start no run (u less
// the matched values, against u less the distinct ones), so the fill never
// reads past them. Every output element is an input element, so A' and S'
// are gathered from the Montgomery inputs by source index: no conversion
// back into Montgomery form.
//
// Three launches a call, every row of the batch in each:
//   k_lookup_keys   from_mont fused into the load: each value as 8
//                   little-endian 32-bit words (its integer order is the
//                   order of the 256-bit number), A's rows then S's;
//   k_lookup_rank   a stable counting rank, rank_i = #{j : (k_j, j) <
//                   (k_i, i)}: a thread an element holds its key in
//                   registers and the row's keys stream past through
//                   shared memory in tiles; each comparison is one
//                   branch-free 288-bit borrow chain (the index as the
//                   lowest word breaks ties), so repeated values (range
//                   lookups repeat small values; theta compression makes
//                   full 256-bit keys) cost what distinct ones do. The
//                   key and its source index go to its rank: sorted A'
//                   and S;
//   k_lookup_merge  one block a row, a thread a position of each tile:
//                   each run start of A' binary-searches its value's
//                   lower bound in sorted S (matched or missing, and the
//                   copy it consumes); block scans of "not consumed" over
//                   S and of "not a start" over A' place the leftovers'
//                   source indices and fill S'; A' and S' are copied from
//                   the Montgomery inputs.
// Bound: bytes, 2 x 64 B an element in and out, against the keys' 2 R u
// products and a comparison sort's 2 R u log2 u comparisons; the simple
// counting rank does u^2 comparisons where a merge sort would do u log u.

#include "field.cuh"

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::kLimbs;
using taiga::kWords;

constexpr int kThreads = 128;       // k_lookup_keys, k_lookup_rank
constexpr int kTileKeys = 256;      // keys a tile of k_lookup_rank (8 KB of shared memory)
constexpr int kMergeThreads = 512;  // k_lookup_merge: one block a row
constexpr int kMergeWarps = kMergeThreads / 32;

// 1 when (a, ia) < (b, ib) in the order of the 288-bit number (a : ia): the
// borrow out of (a : ia) - (b : ib), the index the lowest word.
__device__ __forceinline__ uint32_t key_lt(const Fe& a, uint32_t ia, const Fe& b, uint32_t ib) {
  uint32_t br;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %10;\n\t"
      "subc.cc.u32 t, %2, %11;\n\t"
      "subc.cc.u32 t, %3, %12;\n\t"
      "subc.cc.u32 t, %4, %13;\n\t"
      "subc.cc.u32 t, %5, %14;\n\t"
      "subc.cc.u32 t, %6, %15;\n\t"
      "subc.cc.u32 t, %7, %16;\n\t"
      "subc.cc.u32 t, %8, %17;\n\t"
      "subc.cc.u32 t, %9, %18;\n\t"
      "subc.u32 %0, %19, %19;\n\t}"
      : "=r"(br)
      : "r"(ia), "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
        "r"(a.w[6]), "r"(a.w[7]), "r"(ib), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(0u));
  return br & 1u;
}

__device__ __forceinline__ bool key_eq(const Fe& a, const Fe& b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) d |= a.w[j] ^ b.w[j];
  return d == 0;
}

__device__ __forceinline__ Fe load_key(const uint32_t* p) { return taiga::load_packed(p); }

// --- k_lookup_keys ---------------------------------------------------------------

struct KeysArgs {
  const uint32_t* a;
  const uint32_t* s;
  int64_t a_rs, a_es, s_rs, s_es;  // row and element strides, 32-bit words
  uint32_t* keys;                  // (2R, u, 8): A's rows, then S's
  int64_t R, u;
};

__global__ void __launch_bounds__(kThreads) k_lookup_keys(KeysArgs g, int field) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = blockIdx.y;  // 0 .. 2R - 1
  if (i >= g.u) return;
  const FieldConsts F = kFields[field];
  const bool is_a = r < g.R;
  const int64_t row = is_a ? r : r - g.R;
  const uint32_t* src = is_a ? g.a + row * g.a_rs + i * g.a_es : g.s + row * g.s_rs + i * g.s_es;
  Fe one = taiga::fe_zero();
  one.w[0] = 1u;
  taiga::store_packed(g.keys + (r * g.u + i) * kWords, taiga::fe_mul(taiga::load_limbs(src), one, F));
}

// --- k_lookup_rank ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) k_lookup_rank(const uint32_t* __restrict__ keys,
                                                          uint32_t* __restrict__ sorted,
                                                          uint32_t* __restrict__ src,
                                                          int64_t u) {
  __shared__ uint4 tile[kTileKeys][2];
  const int64_t r = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t* row = keys + r * u * kWords;
  const bool live = i < u;
  const Fe ki = live ? load_key(row + i * kWords) : taiga::fe_zero();
  uint32_t rank = 0;
#pragma unroll 1
  for (int64_t j0 = 0; j0 < u; j0 += kTileKeys) {
    const int m = (int)(u - j0 < kTileKeys ? u - j0 : kTileKeys);
    for (int t = threadIdx.x; t < m; t += kThreads) {
      const uint4* src = reinterpret_cast<const uint4*>(row + (j0 + t) * kWords);
      tile[t][0] = src[0];
      tile[t][1] = src[1];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int t = 0; t < m; t++) {
        const uint4 lo = tile[t][0], hi = tile[t][1];
        const Fe kj{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
        rank += key_lt(kj, (uint32_t)(j0 + t), ki, (uint32_t)i);
      }
    }
    __syncthreads();
  }
  if (live) {
    taiga::store_packed(sorted + (r * u + rank) * kWords, ki);
    src[r * u + rank] = (uint32_t)i;
  }
}

// --- k_lookup_merge --------------------------------------------------------------

// The exclusive prefix sum of x over the block, and its total.
__device__ int block_exclusive(int x, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kMergeWarps; w++) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();  // warp_tot may be reused
  return before + incl - x;
}

// An element's 16 limbs, as four 16-byte vectors.
__device__ __forceinline__ void copy_elem(uint32_t* dst, const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; k++) d[k] = q[k];
}

struct MergeArgs {
  const uint32_t* a;       // the Montgomery inputs, as KeysArgs
  const uint32_t* s;
  int64_t a_rs, a_es, s_rs, s_es;
  const uint32_t* sorted;  // (2R, u, 8): A' rows, then sorted S rows
  const uint32_t* src;     // (2R, u): each sorted key's index in its input row
  uint32_t* leftover;      // (R, u) scratch: the leftovers' indices in S
  int32_t* consumed;       // (R, u) scratch
  uint32_t* ap;            // (R, u, 16) Montgomery
  uint32_t* sp;            // (R, u, 16) Montgomery
  uint8_t* ok;             // (R,)
  int64_t R, u;
};

__device__ __forceinline__ bool run_start(const uint32_t* A, int64_t i) {
  return i == 0 || !key_eq(load_key(A + i * kWords), load_key(A + (i - 1) * kWords));
}

// Each pass walks the row in tiles of kMergeThreads positions, a thread a
// position, so that a warp's loads and stores coalesce; the scans carry
// their totals from tile to tile.
__global__ void __launch_bounds__(kMergeThreads) k_lookup_merge(MergeArgs g) {
  __shared__ int warp_tot[kMergeWarps];
  __shared__ int missing;
  const int64_t r = blockIdx.x, u = g.u;
  const uint32_t* A = g.sorted + r * u * kWords;
  const uint32_t* S = g.sorted + (g.R + r) * u * kWords;
  const uint32_t* a_src = g.src + r * u;
  const uint32_t* s_src = g.src + (g.R + r) * u;
  const uint32_t* a_row = g.a + r * g.a_rs;
  const uint32_t* s_row = g.s + r * g.s_rs;
  uint32_t* left = g.leftover + r * u;
  int32_t* used = g.consumed + r * u;

  if (threadIdx.x == 0) missing = 0;
  for (int64_t j = threadIdx.x; j < u; j += kMergeThreads) used[j] = 0;
  __syncthreads();

  // each run start's value: its lower bound in sorted S, and the copy it consumes
  for (int64_t i = threadIdx.x; i < u; i += kMergeThreads) {
    if (!run_start(A, i)) continue;
    const Fe v = load_key(A + i * kWords);
    int64_t a = 0, b = u;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (key_lt(load_key(S + mid * kWords), 0u, v, 0u)) a = mid + 1; else b = mid;
    }
    if (a < u && key_eq(load_key(S + a * kWords), v)) used[a] = 1;
    else missing = 1;
  }
  __syncthreads();

  // the leftovers' indices in S, ascending by value, to their places
  int base = 0, total;
  for (int64_t j0 = 0; j0 < u; j0 += kMergeThreads) {
    const int64_t j = j0 + threadIdx.x;
    const bool keep = j < u && used[j] == 0;
    const int pos = base + block_exclusive(keep, warp_tot, total);
    if (keep) left[pos] = s_src[j];
    base += total;
  }
  __syncthreads();

  // A' and S', copied from the Montgomery inputs
  base = 0;
  for (int64_t i0 = 0; i0 < u; i0 += kMergeThreads) {
    const int64_t i = i0 + threadIdx.x;
    const bool start = i < u && run_start(A, i);
    const int rank = base + block_exclusive(i < u && !start, warp_tot, total);
    if (i < u) {
      const uint32_t* va = a_row + (int64_t)a_src[i] * g.a_es;
      copy_elem(g.ap + (r * u + i) * kLimbs, va);
      copy_elem(g.sp + (r * u + i) * kLimbs, start ? va : s_row + (int64_t)left[rank] * g.s_es);
    }
    base += total;
  }
  if (threadIdx.x == 0) g.ok[r] = missing ? 0 : 1;
}

int64_t blocks_for(int64_t lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

// a, s: R rows of at least u Montgomery elements, element (row, i) at
// a + row a_rs + i a_es words (strides multiples of 4, pointers 16-byte
// aligned); ap, sp (R, u, 16) contiguous; ok (R,) bytes; scratch of
// 4 R u 8 + 4 R u words (keys, sorted keys, their source indices,
// leftovers, consumed flags), 16-byte aligned.
extern "C" int taiga_permute_pairs(const uint32_t* a, int64_t a_rs, int64_t a_es,
                                   const uint32_t* s, int64_t s_rs, int64_t s_es, uint32_t* ap,
                                   uint32_t* sp, uint8_t* ok, uint32_t* scratch, int64_t R,
                                   int64_t u, int field, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (u <= 0 || u > 0x7FFFFFFF || 2 * R > 65535 || field < 0 || field > 1)
    return (int)cudaErrorInvalidValue;
  uint32_t* keys = scratch;
  uint32_t* sorted = keys + 2 * R * u * kWords;
  uint32_t* src = sorted + 2 * R * u * kWords;
  uint32_t* leftover = src + 2 * R * u;
  int32_t* consumed = reinterpret_cast<int32_t*>(leftover + R * u);
  const dim3 grid((unsigned)blocks_for(u), (unsigned)(2 * R));
  k_lookup_keys<<<grid, kThreads, 0, stream>>>(KeysArgs{a, s, a_rs, a_es, s_rs, s_es, keys, R, u},
                                               field);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  k_lookup_rank<<<grid, kThreads, 0, stream>>>(keys, sorted, src, u);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const MergeArgs m{a, s, a_rs, a_es, s_rs, s_es, sorted, src, leftover, consumed, ap, sp, ok,
                    R, u};
  k_lookup_merge<<<(unsigned)R, kMergeThreads, 0, stream>>>(m);
  return (int)cudaGetLastError();
}
