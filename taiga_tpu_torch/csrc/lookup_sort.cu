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
// back into Montgomery form. Equal values have equal limbs, so the order
// among equal keys does not show in the output; a key's index only makes
// the ranks distinct.
//
// Design: a row is cut into tiles of kTile = 1,024 positions, and every
// launch spreads a row over blocks, one a (row, tile), every row of the
// batch in each. Five launches a call:
//   k_lookup_sort      from_mont fused into the load: each value as 8
//                      little-endian 32-bit words (its integer order is the
//                      order of the 256-bit number) with its index, a
//                      tile of A or S sorted by (key, index) in shared
//                      memory: a bitonic network of 55 compare-exchange
//                      stages, each a branch-free 288-bit borrow chain;
//   k_lookup_rank      a thread a key: its rank in the row is its place in
//                      its sorted tile plus, for every other tile, the keys
//                      there that precede it (upper bound in earlier tiles,
//                      lower bound in later ones: binary searches of 10
//                      probes into tiles that L2 holds; a warp holds 32
//                      neighbouring sorted keys, so its probes fall on the
//                      same few keys). The ranks are distinct with no index
//                      compared. The key's source index goes to its rank.
//                      The same searches tell whether an A key starts its
//                      run (no equal key before it); a run start then finds
//                      its value's lower bound in sorted S over S's tiles,
//                      marks that copy consumed, or clears ok;
//   k_lookup_counts    each tile's count of A' positions that start no run
//                      and of S positions not consumed (block sums);
//   k_lookup_leftovers the unconsumed S positions' source indices, in
//                      order, to their places: the earlier tiles' counts
//                      plus a block scan;
//   k_lookup_fill      A' and S', copied from the Montgomery inputs: S' at
//                      a run start from A', elsewhere the leftover of the
//                      position's rank among the non-starts (the earlier
//                      tiles' counts plus a block scan).
// Bound: bytes, 2 x 64 B an element in and out, against the keys' 2 R u
// products and a comparison sort's 2 R u log2 u comparisons. The kernels
// do 2 R u (log2 T (log2 T + 1) / 4) comparisons in the tile sorts (T =
// kTile; 27.5 a key) and about 2 R u (u / T) log2 T in the co-ranks (70 a
// key at u = 8,183) plus a run start's log2 u into S, where a counting
// rank does u^2 a row; no stage is serial along a row.

#include "field.cuh"

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::kLimbs;
using taiga::kWords;

constexpr int kTile = 1024;          // positions a tile
constexpr int kSortThreads = 512;    // k_lookup_sort: a compare-exchange a thread a stage
constexpr int kRankThreads = 256;    // k_lookup_rank: a thread a key
constexpr int kScanThreads = kTile;  // counts, leftovers, fill: a thread a position of a tile
constexpr int kScanWarps = kScanThreads / 32;

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

// The keys of K (m sorted keys, 8 words each) below k (lower bound), or at
// or below k (upper bound).
template <bool kUpper>
__device__ __forceinline__ int count_before(const uint32_t* K, int m, const Fe& k) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const Fe x = load_key(K + (int64_t)mid * kWords);
    const bool before = kUpper ? !key_lt(k, 0u, x, 0u) : key_lt(x, 0u, k, 0u);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int tile_len(int64_t t, int64_t u) {
  const int64_t rest = u - t * kTile;
  return rest < kTile ? (int)rest : kTile;
}

struct Args {
  const uint32_t* a;      // the Montgomery inputs: element (row, i) at a + row a_rs + i a_es
  const uint32_t* s;
  int64_t a_rs, a_es, s_rs, s_es;
  uint32_t* tkeys;        // (2R, u, 8): each tile's keys sorted; A's rows, then S's
  uint32_t* tidx;         // (2R, u): their source indices
  uint32_t* src;          // (2R, u): the source index of each rank (A', then sorted S)
  int32_t* start;         // (R, u): 1 where A'[i] starts a run
  int32_t* used;          // (R, u): 1 where sorted S's copy is consumed
  uint32_t* left;         // (R, u): the leftovers' source indices in S, in order
  int32_t* counts;        // (R, tiles, 2): a tile's non-starts of A', unconsumed of S
  uint32_t* ap;           // (R, u, 16) Montgomery
  uint32_t* sp;           // (R, u, 16) Montgomery
  uint8_t* ok;            // (R,)
  int64_t R, u, tiles;
};

// --- k_lookup_sort -------------------------------------------------------------

__global__ void __launch_bounds__(kSortThreads, 1) k_lookup_sort(Args g, int field) {
  __shared__ uint32_t s[kWords + 1][kTile];  // 8 word planes, the index the ninth
  const FieldConsts F = kFields[field];
  const int64_t r = blockIdx.y, t0 = (int64_t)blockIdx.x * kTile, u = g.u;
  const int m = tile_len(blockIdx.x, u);
  const bool is_a = r < g.R;
  const int64_t row = is_a ? r : r - g.R;
  const uint32_t* in = is_a ? g.a + row * g.a_rs : g.s + row * g.s_rs;
  const int64_t es = is_a ? g.a_es : g.s_es;
  Fe one = taiga::fe_zero();
  one.w[0] = 1u;
  for (int i = threadIdx.x; i < kTile; i += kSortThreads) {
    Fe k;
    uint32_t idx = 0xFFFFFFFFu;  // the padding sorts last: no value reaches 2^256 - 1
#pragma unroll
    for (int w = 0; w < kWords; w++) k.w[w] = 0xFFFFFFFFu;
    if (i < m) {
      k = taiga::fe_mul(taiga::load_limbs(in + (t0 + i) * es), one, F);
      idx = (uint32_t)(t0 + i);
    }
#pragma unroll
    for (int w = 0; w < kWords; w++) s[w][i] = k.w[w];
    s[kWords][i] = idx;
  }
  // the later launches' initial state: no copy of S consumed, every lookup ok
  if (!is_a)
    for (int i = threadIdx.x; i < m; i += kSortThreads) g.used[row * u + t0 + i] = 0;
  if (is_a && blockIdx.x == 0 && threadIdx.x == 0) g.ok[row] = 1;
  __syncthreads();

  const int t = threadIdx.x;  // compare-exchange t of kTile / 2 in every stage
#pragma unroll 1
  for (int k = 2; k <= kTile; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1)), hi = lo | j;
      Fe x, y;
#pragma unroll
      for (int w = 0; w < kWords; w++) {
        x.w[w] = s[w][lo];
        y.w[w] = s[w][hi];
      }
      const uint32_t ix = s[kWords][lo], iy = s[kWords][hi];
      const bool up = (lo & k) == 0;  // this run of k ascends
      if (up ? key_lt(y, iy, x, ix) : key_lt(x, ix, y, iy)) {
#pragma unroll
        for (int w = 0; w < kWords; w++) {
          s[w][lo] = y.w[w];
          s[w][hi] = x.w[w];
        }
        s[kWords][lo] = iy;
        s[kWords][hi] = ix;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < m; i += kSortThreads) {
    Fe k;
#pragma unroll
    for (int w = 0; w < kWords; w++) k.w[w] = s[w][i];
    taiga::store_packed(g.tkeys + (r * u + t0 + i) * kWords, k);
    g.tidx[r * u + t0 + i] = s[kWords][i];
  }
}

// --- k_lookup_rank -------------------------------------------------------------

__global__ void __launch_bounds__(kRankThreads) k_lookup_rank(Args g) {
  const int64_t r = blockIdx.y, u = g.u;
  const int64_t i = (int64_t)blockIdx.x * kRankThreads + threadIdx.x;  // tile-sorted place
  if (i >= u) return;
  const uint32_t* K = g.tkeys + r * u * kWords;
  const Fe k = load_key(K + i * kWords);
  const int64_t t = i / kTile;
  int64_t rank = i - t * kTile;
  bool start = rank == 0 || !key_eq(load_key(K + (i - 1) * kWords), k);
  for (int64_t tt = 0; tt < g.tiles; tt++) {
    if (tt == t) continue;
    const uint32_t* T = K + tt * kTile * kWords;
    const int m = tile_len(tt, u);
    if (tt < t) {  // equal keys there have smaller indices: they come first
      const int c = count_before<true>(T, m, k);
      rank += c;
      if (c > 0 && key_eq(load_key(T + (int64_t)(c - 1) * kWords), k)) start = false;
    } else {
      rank += count_before<false>(T, m, k);
    }
  }
  g.src[r * u + rank] = g.tidx[r * u + i];
  if (r >= g.R) return;
  g.start[r * u + rank] = start;
  if (!start) return;
  // a distinct value of A: the first copy of it in sorted S, if S holds it
  const uint32_t* S = g.tkeys + (g.R + r) * u * kWords;
  int64_t lb = 0;
  bool found = false;
  for (int64_t tt = 0; tt < g.tiles; tt++) {
    const uint32_t* T = S + tt * kTile * kWords;
    const int m = tile_len(tt, u);
    const int c = count_before<false>(T, m, k);
    lb += c;
    if (c < m && key_eq(load_key(T + (int64_t)c * kWords), k)) found = true;
  }
  if (found) g.used[r * u + lb] = 1;  // distinct values: distinct copies
  else g.ok[r] = 0;                  // every writer stores the same 0
}

// --- k_lookup_counts, k_lookup_leftovers, k_lookup_fill --------------------------

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
  for (int w = 0; w < kScanWarps; w++) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();  // warp_tot may be reused
  return before + incl - x;
}

// The sum of a row's first `tiles` counts (a stride of 2 words), on every
// thread of the block.
__device__ int earlier_tiles(const int32_t* c, int64_t tiles, int* shared) {
  if (threadIdx.x < 32) {
    int s = 0;
    for (int64_t t = threadIdx.x; t < tiles; t += 32) s += c[2 * t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, d);
    if (threadIdx.x == 0) *shared = s;
  }
  __syncthreads();
  return *shared;
}

__global__ void __launch_bounds__(kScanThreads) k_lookup_counts(Args g) {
  __shared__ int warp_tot[kScanWarps];
  const int64_t r = blockIdx.y, u = g.u;
  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;
  const bool live = i < u;
  int total;
  block_exclusive(live && g.start[r * u + i] == 0, warp_tot, total);
  if (threadIdx.x == 0) g.counts[(r * g.tiles + blockIdx.x) * 2] = total;
  block_exclusive(live && g.used[r * u + i] == 0, warp_tot, total);
  if (threadIdx.x == 0) g.counts[(r * g.tiles + blockIdx.x) * 2 + 1] = total;
}

__global__ void __launch_bounds__(kScanThreads) k_lookup_leftovers(Args g) {
  __shared__ int warp_tot[kScanWarps];
  __shared__ int base;
  const int64_t r = blockIdx.y, u = g.u;
  const int64_t j = (int64_t)blockIdx.x * kTile + threadIdx.x;  // sorted S
  const int before = earlier_tiles(g.counts + r * g.tiles * 2 + 1, blockIdx.x, &base);
  const bool keep = j < u && g.used[r * u + j] == 0;
  int total;
  const int pos = before + block_exclusive(keep, warp_tot, total);
  if (keep) g.left[r * u + pos] = g.src[(g.R + r) * u + j];
}

// An element's 16 limbs, as four 16-byte vectors.
__device__ __forceinline__ void copy_elem(uint32_t* dst, const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; k++) d[k] = q[k];
}

__global__ void __launch_bounds__(kScanThreads) k_lookup_fill(Args g) {
  __shared__ int warp_tot[kScanWarps];
  __shared__ int base;
  const int64_t r = blockIdx.y, u = g.u;
  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;  // A'
  const int before = earlier_tiles(g.counts + r * g.tiles * 2, blockIdx.x, &base);
  const bool live = i < u;
  const bool start = live && g.start[r * u + i] != 0;
  int total;
  const int rank = before + block_exclusive(live && !start, warp_tot, total);
  if (!live) return;
  const uint32_t* va = g.a + r * g.a_rs + (int64_t)g.src[r * u + i] * g.a_es;
  copy_elem(g.ap + (r * u + i) * kLimbs, va);
  copy_elem(g.sp + (r * u + i) * kLimbs,
            start ? va : g.s + r * g.s_rs + (int64_t)g.left[r * u + rank] * g.s_es);
}

int64_t tiles_of(int64_t u) { return (u + kTile - 1) / kTile; }

}  // namespace

// Scratch words taiga_permute_pairs needs for R rows of u.
extern "C" int64_t taiga_permute_pairs_scratch(int64_t R, int64_t u) {
  return R * u * (2 * kWords + 7) + 2 * R * tiles_of(u);
}

// a, s: R rows of at least u Montgomery elements, element (row, i) at
// a + row a_rs + i a_es words (strides multiples of 4, pointers 16-byte
// aligned); ap, sp (R, u, 16) contiguous; ok (R,) bytes; scratch of
// taiga_permute_pairs_scratch(R, u) words, 16-byte aligned.
extern "C" int taiga_permute_pairs(const uint32_t* a, int64_t a_rs, int64_t a_es,
                                   const uint32_t* s, int64_t s_rs, int64_t s_es, uint32_t* ap,
                                   uint32_t* sp, uint8_t* ok, uint32_t* scratch, int64_t R,
                                   int64_t u, int field, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (u <= 0 || u > 0x7FFFFFFF || 2 * R > 65535 || field < 0 || field > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(u);
  Args g{a, s, a_rs, a_es, s_rs, s_es};
  g.tkeys = scratch;
  g.tidx = g.tkeys + 2 * R * u * kWords;
  g.src = g.tidx + 2 * R * u;
  g.start = reinterpret_cast<int32_t*>(g.src + 2 * R * u);
  g.used = g.start + R * u;
  g.left = reinterpret_cast<uint32_t*>(g.used + R * u);
  g.counts = reinterpret_cast<int32_t*>(g.left + R * u);
  g.ap = ap;
  g.sp = sp;
  g.ok = ok;
  g.R = R;
  g.u = u;
  g.tiles = tiles;
  k_lookup_sort<<<dim3((unsigned)tiles, (unsigned)(2 * R)), kSortThreads, 0, stream>>>(g, field);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 rank_grid((unsigned)((u + kRankThreads - 1) / kRankThreads), (unsigned)(2 * R));
  k_lookup_rank<<<rank_grid, kRankThreads, 0, stream>>>(g);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)tiles, (unsigned)R);
  k_lookup_counts<<<grid, kScanThreads, 0, stream>>>(g);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  k_lookup_leftovers<<<grid, kScanThreads, 0, stream>>>(g);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  k_lookup_fill<<<grid, kScanThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}
