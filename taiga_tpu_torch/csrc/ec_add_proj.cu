// K2 / K3: complete projective point addition over limb-major (16, B)
// coordinates, plain (K2) and with a lane select sel ? P1 + P2 : P1 (K3);
// K3 chained into the MSMs' segmented reduction (ec_seg_rows, the rows of
// a call in one launch; ec_seg_tile, tiles of at most 128 lanes in one
// launch); and K2 chained into a Horner evaluation (ec_horner) and into an
// MSM's bucket weighting (ec_bucket_weights), each one launch.
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_proj_lm (K2) and
// ::ec_add_proj_sel_lm (K3), core _ec_add_proj_core (RCB Algorithm 7), the
// rounds over K3 of taiga_tpu/ops/msm.py::_seg_rounds (:74-88), the scan
// over K2 that combines an MSM's window sums (:417-424), and the bit-masked
// roll-add tree over K2 with the Horner over the bits that weight its
// buckets (:140-173).
//
// K2, one thread per lane: 6 coalesced limb-major inputs, 3 outputs; 12
// Montgomery products (~3,200 32-bit multiply-adds) per 576 bytes moved, so
// bound by operations on this card. The whole formula stays in registers
// (the fusion the Pallas kernel existed for) and every field operation runs
// on the hardware's carry chains (csrc/field.cuh); at most 128 registers a
// thread keep 16 warps on an SM to hide the products' serial chains, which
// still hold it at ~2.4x its operations bound (an NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md section 6).
//
// K3: a lane whose select is 0 only copies P1, so with one thread a lane a
// warp paid the whole add whenever any of its 32 lanes was selected -- with
// scattered selections nearly every warp. Here a block of 128 lanes stages
// P1 (and P2 where selected) in shared memory with coalesced loads, lists
// its selected lanes (a ballot and a popcount a warp, a prefix over the
// four warps), and thread t < count adds lane list[t] there; the block
// writes its lanes back coalesced. A launch still costs about one add's
// latency a wave of resident blocks (4 an SM at 128 registers), however
// few lanes a block selects (tools/torch_k3_waves.py, PERF.md section 6).
//
// The segmented reduction. The reference's rounds are Hillis-Steele: in
// round r every lane adds its same-run neighbour at distance 2^r, O(n
// rounds) adds. Its callers read only the lanes whose offset from their
// run's first lane is a multiple of 2^rounds (run starts, and _compact's
// stride-64 partials). At such a lane the rounds compute the aligned
// binary tree ((P0 + P1) + (P2 + P3)) + ... over [i, i + 2^rounds), cut at
// the run's end, and every lane of that tree sits at an offset that is a
// multiple of 2^r in round r. So here round r adds only at offsets
// divisible by 2^(r+1): the same field operations on the same operands in
// the same order, so those lanes' limbs are the reference's, in about one
// add a lane (n - runs in all). No add of a round reads a lane that the
// round writes, so a round needs no copy and no barrier inside it. The
// contract (ff_kernels.ec_seg_rounds_lm): a lane at such an offset holds
// the reference's value; every other lane keeps its input point; keys are
// sorted along each row. Bound by operations, counted as the aligned adds
// (chip_smoke.py), but run at the latency of a few dependent adds a round.
// A round lists its adds (a ballot a warp) and runs each on a group of 8
// threads (csrc/ec_group.cuh, 2 product stages an add), so the late
// rounds' few adds cost two product latencies, not twelve. ec_seg_tile
// holds 512 lanes of tiles of <= 128 lanes in shared memory and runs every
// round there (a tile's edges count as run edges), one thread an add while
// a round's adds outnumber the block's groups. ec_seg_rows runs
// rows of any length in one cooperative launch, 128 lanes a block at a
// time: a grid-wide barrier between rounds, and the first round with no
// add anywhere ends the rounds (no later round could have one), so a call
// whose static round count covers the whole row stops at its longest run
// (the MSMs key their padding lanes apart for this).
//
// ec_horner: acc = term[W-1]; for w = W-2 .. 0: `doublings` times
// acc = 2 acc, then acc = acc + term[w]. The MSMs run it over one or a few
// columns (their window sums), so each column is one chain of up to 279
// dependent adds: bound by the chain's latency, not by the card's width.
// One launch runs the whole chain on a group of 8 threads (two product
// stages an add), the doublings in the P = Q form (ec_dbl_proj_group: no
// additions before stage A), the products inlined.
//
// ec_bucket_weights: an MSM window's bucket sums B_j, j < 2^c, weighted as
// sum_j j B_j, for L columns: the reference masks the buckets by each bit t
// of j, reduces each (bit, column) row by a roll-add tree over all 2^c
// lanes, and runs a Horner over the bits from lane 0 of each row. Lane 0
// is the aligned tree of the row (2^c - 1 adds of the c 2^c the tree
// computes). One launch: a thread-block cluster of c blocks a column, block
// t reducing bit row t on groups of 8 threads (the masked buckets read
// once from device memory, the tree's levels in shared memory), then
// block 0 reads the c row sums through distributed shared memory and one
// group runs the Horner (c - 1 doublings and adds). Bound by the latency
// of the tree's c levels and the Horner's chain.

#include <cooperative_groups.h>

#include "ec_group.cuh"

namespace {

using taiga::Fe;

constexpr int kSelLanes = 128;  // lanes (and threads) of a K3, row or tile block
constexpr int kSelWarps = kSelLanes / 32;

__global__ void __launch_bounds__(128, 4)
k_ec_add_proj(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
              uint32_t* __restrict__ xo, uint32_t* __restrict__ yo, uint32_t* __restrict__ zo,
              int64_t B, int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  Fe ax = taiga::load_fe(x1, B, lane);
  Fe ay = taiga::load_fe(y1, B, lane);
  Fe az = taiga::load_fe(z1, B, lane);
  Fe bx = taiga::load_fe(x2, B, lane);
  Fe by = taiga::load_fe(y2, B, lane);
  Fe bz = taiga::load_fe(z2, B, lane);
  Fe rx, ry, rz;
  taiga::ec_add_proj(rx, ry, rz, ax, ay, az, bx, by, bz, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
}

// Lists the selected lanes of kSub sub-blocks of kSelLanes lanes (lane
// q * kSelLanes + t is thread t's pred[q], listed as value[q]) in list[0,
// count) in ascending order; returns count. Every thread of the block
// calls it; the list is visible to all when it returns.
template <int kSub, class T>
__device__ __forceinline__ int compact_block(const bool (&pred)[kSub], const T (&value)[kSub],
                                             T* list, int* warp_count) {
  const int t = threadIdx.x, warp = t / 32, l = t % 32;
  unsigned m[kSub];
#pragma unroll
  for (int q = 0; q < kSub; q++) {
    m[q] = __ballot_sync(0xFFFFFFFFu, pred[q]);
    if (l == 0) warp_count[q * kSelWarps + warp] = __popc(m[q]);
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int q = 0; q < kSub; q++) {
    int off = count;
#pragma unroll
    for (int k = 0; k < kSelWarps; k++) {
      off += k < warp ? warp_count[q * kSelWarps + k] : 0;
      count += warp_count[q * kSelWarps + k];
    }
    if (pred[q]) list[off + __popc(m[q] & ((1u << l) - 1))] = value[q];
  }
  __syncthreads();
  return count;
}

// Points of a block in shared memory: coordinate c, word w of lane i at
// rows[8c + w][i] (neighbouring lanes on neighbouring banks).
template <int kN>
using Rows = uint32_t (*)[kN];

// Lane `lane` of limb-major (16, B) x, y, z packed into column i.
template <int kN>
__device__ __forceinline__ void pack_lane(Rows<kN> rows, int i, const uint32_t* __restrict__ x,
                                          const uint32_t* __restrict__ y,
                                          const uint32_t* __restrict__ z, int64_t B,
                                          int64_t lane) {
  const uint32_t* src[3] = {x, y, z};
#pragma unroll
  for (int c = 0; c < 3; c++) {
#pragma unroll
    for (int w = 0; w < taiga::kWords; w++) {
      rows[c * taiga::kWords + w][i] =
          src[c][2 * w * B + lane] | (src[c][(2 * w + 1) * B + lane] << 16);
    }
  }
}

template <int kN>
__device__ __forceinline__ void unpack_lane(Rows<kN> rows, int i, uint32_t* __restrict__ x,
                                            uint32_t* __restrict__ y, uint32_t* __restrict__ z,
                                            int64_t B, int64_t lane) {
  uint32_t* dst[3] = {x, y, z};
#pragma unroll
  for (int c = 0; c < 3; c++) {
#pragma unroll
    for (int w = 0; w < taiga::kWords; w++) {
      const uint32_t v = rows[c * taiga::kWords + w][i];
      dst[c][2 * w * B + lane] = v & 0xFFFFu;
      dst[c][(2 * w + 1) * B + lane] = v >> 16;
    }
  }
}

template <int kN>
__device__ __forceinline__ void read_pt(Fe (&p)[3], Rows<kN> rows, int i) {
#pragma unroll
  for (int c = 0; c < 3; c++) {
#pragma unroll
    for (int w = 0; w < taiga::kWords; w++) p[c].w[w] = rows[c * taiga::kWords + w][i];
  }
}

template <int kN>
__device__ __forceinline__ void write_pt(Rows<kN> rows, int i, const Fe& x, const Fe& y,
                                         const Fe& z) {
#pragma unroll
  for (int w = 0; w < taiga::kWords; w++) {
    rows[w][i] = x.w[w];
    rows[taiga::kWords + w][i] = y.w[w];
    rows[2 * taiga::kWords + w][i] = z.w[w];
  }
}

// K3: lane i <- sel[i] ? P1[i] + P2[i] : P1[i], lane-wise, a block of
// kSelLanes lanes at a time. The block stages P1, and P2 where it is
// selected, in shared memory with coalesced loads, lists its selected
// lanes, and thread t < count adds lane list[t] from shared memory into
// P1's copy; the block then writes its lanes back coalesced. Adds run in
// full warps (only the last busy one partly filled) and touch device
// memory only through coalesced rows.
__global__ void __launch_bounds__(kSelLanes, 4)
k_ec_add_sel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
             const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
             const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
             const uint32_t* __restrict__ sel, uint32_t* __restrict__ xo,
             uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B, int field) {
  __shared__ uint32_t p1[3 * taiga::kWords][kSelLanes], p2[3 * taiga::kWords][kSelLanes];
  __shared__ uint8_t list[kSelLanes];
  __shared__ int warp_count[kSelWarps];
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * kSelLanes + t;
  const bool pred[1] = {lane < B && sel[lane] != 0};
  const uint8_t value[1] = {(uint8_t)t};
  if (lane < B) pack_lane(p1, t, x1, y1, z1, B, lane);
  if (pred[0]) pack_lane(p2, t, x2, y2, z2, B, lane);
  const int count = compact_block<1>(pred, value, list, warp_count);
  if (t < count) {
    const int i = list[t];
    Fe a[3], b[3], r[3];
    read_pt(a, p1, i);
    read_pt(b, p2, i);
    taiga::ec_add_proj(r[0], r[1], r[2], a[0], a[1], a[2], b[0], b[1], b[2],
                       taiga::kFields[field]);
    write_pt(p1, i, r[0], r[1], r[2]);
  }
  __syncthreads();
  if (lane < B) unpack_lane(p1, t, xo, yo, zo, B, lane);
}

// The product of each chained kernel below, as measured against the other
// choice in one chip call (tools/torch_msm_times.py, PERF.md section 6):
// the segmented rounds and the bucket weighting call the one copy
// (fe_mul_call; inlined, the rounds' group add spilled and phase B, C and
// the rows took 9-34% longer), ec_horner inlines it (its one busy group a
// column paid 5% for the calls).
using SegMul = taiga::MulCall;
using WeightMul = taiga::MulCall;
using HornerMul = taiga::MulInline;

// Lists held by a block for a round: one thread an add while the adds
// outnumber the block's groups (a pass of twelve products on one thread
// beats two passes of two product stages on groups where the SM is full:
// on an NVIDIA H100 at 700 W phase B ran 0.28 ms on groups only, 0.21 with
// this switch at four passes of groups and 0.20 at one,
// tools/torch_msm_times.py, PERF.md section 6), else a group of kGroup
// threads an add.
constexpr int kGroups = kSelLanes / taiga::kGroup;  // groups of a 128-thread block

// acc <- acc + P(acc's lane + s) at each listed lane (the points
// limb-major in device memory (16, B), or in shared memory), each add by a
// group, or by one thread where kOneThread allows it and the adds
// outnumber the groups. `Pts` maps a listed value to its lane, and reads
// and writes a lane's point.
template <bool kOneThread, class Pts, class T>
__device__ __forceinline__ void run_adds(Pts pts, const T* list, int count, int64_t s,
                                         const taiga::FieldConsts& F,
                                         taiga::GroupScratch* scratch) {
  const int t = threadIdx.x;
  if (kOneThread && count > kGroups) {
    for (int pass = 0; pass < count; pass += kSelLanes) {
      if (pass + t >= count) break;
      const int64_t i = pts.lane(list[pass + t]);
      Fe a[3], b[3], r[3];
      pts.read(a, i);
      pts.read(b, i + s);
      taiga::ec_add_proj<SegMul>(r[0], r[1], r[2], a[0], a[1], a[2], b[0], b[1], b[2], F);
      pts.write(i, r);
    }
    return;
  }
  const int g = t / taiga::kGroup, rank = t % taiga::kGroup;
  const unsigned gmask = taiga::group_mask(t);
  for (int pass = 0; pass < count; pass += kGroups) {
    if (pass + g >= count) break;  // the group leaves together
    const int64_t i = pts.lane(list[pass + g]);
    Fe a[3], b[3], r[3];
    pts.read(a, i);
    pts.read(b, i + s);
    taiga::ec_add_proj_group<SegMul>(r[0], r[1], r[2], a[0], a[1], a[2], b[0], b[1],
                                             b[2], F, scratch[g], rank, gmask);
    if (rank == 0) pts.write(i, r);
  }
}

// A block's points in shared memory (Rows), lane i at column i.
template <int kN>
struct SharedPts {
  Rows<kN> rows;
  __device__ int64_t lane(int v) const { return v; }
  __device__ void read(Fe (&p)[3], int64_t i) const { read_pt(p, rows, (int)i); }
  __device__ void write(int64_t i, const Fe (&p)[3]) const {
    write_pt(rows, (int)i, p[0], p[1], p[2]);
  }
};

// Points limb-major in device memory, (16, B) a coordinate; a listed value
// is a lane's offset from `base`.
struct DevicePts {
  uint32_t* x;
  uint32_t* y;
  uint32_t* z;
  int64_t B, base;
  __device__ int64_t lane(int v) const { return base + v; }
  __device__ void read(Fe (&p)[3], int64_t i) const {
    p[0] = taiga::load_fe(x, B, i);
    p[1] = taiga::load_fe(y, B, i);
    p[2] = taiga::load_fe(z, B, i);
  }
  __device__ void write(int64_t i, const Fe (&p)[3]) const {
    taiga::store_fe(x, B, i, p[0]);
    taiga::store_fe(y, B, i, p[1]);
    taiga::store_fe(z, B, i, p[2]);
  }
};

// The first lane of lane i's run among lanes [lo, i] (keys sorted there):
// the first lane with lane i's key, by bisection.
template <class K>
__device__ __forceinline__ int64_t run_start(const K* keys, int64_t lo, int64_t i) {
  const K k = keys[i];
  int64_t hi = i;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] == k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// (16, B) limb-major lane `lane` of x, y, z copied to xo, yo, zo.
__device__ __forceinline__ void copy_lane(const uint32_t* __restrict__ x,
                                          const uint32_t* __restrict__ y,
                                          const uint32_t* __restrict__ z, uint32_t* xo,
                                          uint32_t* yo, uint32_t* zo, int64_t B, int64_t lane) {
#pragma unroll
  for (int j = 0; j < taiga::kLimbs; j++) {
    xo[j * B + lane] = x[j * B + lane];
    yo[j * B + lane] = y[j * B + lane];
    zo[j * B + lane] = z[j * B + lane];
  }
}

constexpr int kTileSub = 4;                         // sub-blocks of a tile block
constexpr int kTileBlock = kTileSub * kSelLanes;    // lanes of a tile block
constexpr size_t kTileSmem = (size_t)kTileBlock * (3 * taiga::kWords * 4 + 2 + 2)
                             + kTileSub * kSelWarps * 4;

// The rounds r < rounds (s = 2^r) of the segmented reduction over tiles of
// `tile` lanes (a power of two dividing kSelLanes; B a multiple of tile),
// round r adding at the offsets divisible by 2^(r+1) from a run's first
// lane (a tile's first lane starts a run). A block holds kTileBlock lanes
// in shared memory: the points, then the round's list, the lanes' offsets
// in their runs (found by bisecting the keys once: lane i + s is in lane
// i's run when its offset is lane i's + s) and the warp counts. A lane
// whose offset is a multiple of 2^rounds writes its sum; every other lane
// its input.
__global__ void __launch_bounds__(kSelLanes, 4)
k_ec_seg_tile(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, const int64_t* __restrict__ keys, int tile,
              int rounds, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
              uint32_t* __restrict__ zo, int64_t B, int field) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ taiga::GroupScratch scratch[kGroups];
  Rows<kTileBlock> pts = reinterpret_cast<Rows<kTileBlock>>(smem);
  uint16_t* list = reinterpret_cast<uint16_t*>(pts + 3 * taiga::kWords);
  uint16_t* off = list + kTileBlock;
  int* warp_count = reinterpret_cast<int*>(off + kTileBlock);
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTileBlock;
#pragma unroll
  for (int q = 0; q < kTileSub; q++) {
    const int i = q * kSelLanes + t;
    if (base + i < B) {
      pack_lane(pts, i, x, y, z, B, base + i);
      off[i] = (uint16_t)(i - run_start(keys + base, i & ~(tile - 1), i));
    }
  }
  __syncthreads();
  const taiga::FieldConsts F = taiga::kFields[field];
  const SharedPts<kTileBlock> sp{pts};
  for (int r = 0; r < rounds; r++) {
    const int s = 1 << r;
    bool pred[kTileSub];
    uint16_t value[kTileSub];
#pragma unroll
    for (int q = 0; q < kTileSub; q++) {
      const int i = q * kSelLanes + t;
      value[q] = (uint16_t)i;
      pred[q] = base + i < B && (off[i] & (2 * s - 1)) == 0 && (i & (tile - 1)) + s < tile &&
                off[i + s] == off[i] + s;
    }
    const int count = compact_block<kTileSub>(pred, value, list, warp_count);
    if (count == 0) break;  // the block's later rounds have no add either
    run_adds<true>(sp, list, count, s, F, scratch);
    __syncthreads();
  }
  const int defined = (1 << rounds) - 1;
#pragma unroll
  for (int q = 0; q < kTileSub; q++) {
    const int i = q * kSelLanes + t;
    if (base + i >= B) continue;
    if ((off[i] & defined) == 0) {
      unpack_lane(pts, i, xo, yo, zo, B, base + i);
    } else {
      copy_lane(x, y, z, xo, yo, zo, B, base + i);
    }
  }
}

// The rounds r < rounds of the segmented reduction over B / n rows of n
// lanes, in one cooperative launch (every block resident). First each lane
// finds its offset in its run (off, int32 scratch of B) and copies its
// point to the output; then each round, between grid-wide barriers, lists
// its adds (lane i + s is in lane i's run when its offset is lane i's + s)
// span by span of kSelLanes lanes, a span's at most 64 adds on the
// block's 16 groups, on the output in device memory; counts[r] sums the
// round's adds, and the first round with none ends the loop. Last, every
// lane whose offset is not a multiple of 2^rounds gets its input back.
__global__ void __launch_bounds__(kSelLanes, 4)
k_ec_seg_rows(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, const int64_t* __restrict__ keys, int64_t n,
              int rounds, uint32_t* xo, uint32_t* yo, uint32_t* zo, int32_t* off,
              int32_t* counts, int64_t B, int field) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ int list[kSelLanes];
  __shared__ int warp_count[kSelWarps];
  __shared__ taiga::GroupScratch scratch[kGroups];
  const int t = threadIdx.x;
  const int64_t nspan = (B + kSelLanes - 1) / kSelLanes;
  for (int64_t lane = (int64_t)blockIdx.x * kSelLanes + t; lane < B;
       lane += (int64_t)gridDim.x * kSelLanes) {
    off[lane] = (int32_t)(lane - run_start(keys, lane - lane % n, lane));
    copy_lane(x, y, z, xo, yo, zo, B, lane);
  }
  if (blockIdx.x == 0) {
    for (int r = t; r < rounds; r += kSelLanes) counts[r] = 0;
  }
  grid.sync();
  const taiga::FieldConsts F = taiga::kFields[field];
  for (int r = 0; r < rounds; r++) {
    const int64_t s = (int64_t)1 << r;
    int total = 0;
    for (int64_t span = blockIdx.x; span < nspan; span += gridDim.x) {
      const int64_t base = span * kSelLanes, lane = base + t;
      const bool pred[1] = {lane < B && (off[lane] & (2 * s - 1)) == 0 && lane % n + s < n &&
                            off[lane + s] == off[lane] + s};
      const int value[1] = {t};
      const int count = compact_block<1>(pred, value, list, warp_count);
      run_adds<false>(DevicePts{xo, yo, zo, B, base}, list, count, s, F, scratch);
      total += count;
    }
    if (t == 0 && total > 0) atomicAdd(&counts[r], total);
    grid.sync();
    if (*(volatile int32_t*)&counts[r] == 0) break;  // no later round has an add
  }
  const int64_t defined = rounds >= 31 ? 0x7FFFFFFF : ((int64_t)1 << rounds) - 1;
  for (int64_t lane = (int64_t)blockIdx.x * kSelLanes + t; lane < B;
       lane += (int64_t)gridDim.x * kSelLanes) {
    const int32_t o = off[lane];
    if ((o & 1) == 0 && (o & defined) != 0) copy_lane(x, y, z, xo, yo, zo, B, lane);
  }
}

constexpr int kHornerThreads = 128;
constexpr int kHornerCols = kHornerThreads / taiga::kGroup;  // columns a block

// terms: (16, W, L) limb-major, term w of column l at w * L + l of each
// limb row; out: (16, L).
__global__ void __launch_bounds__(kHornerThreads)
k_ec_horner(const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
            const uint32_t* __restrict__ wz, uint32_t* __restrict__ xo,
            uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int W, int64_t L,
            int doublings, int field) {
  __shared__ taiga::GroupScratch scratch[kHornerCols];
  const int tid = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.x * kHornerCols + tid / taiga::kGroup;
  if (col >= L) return;  // a column's group leaves together
  const int rank = tid % taiga::kGroup;
  const unsigned gmask = taiga::group_mask(tid);
  taiga::GroupScratch& s = scratch[tid / taiga::kGroup];
  const taiga::FieldConsts F = taiga::kFields[field];
  const int64_t stride = (int64_t)W * L;  // between limb rows
  Fe ax = taiga::load_fe(wx + (int64_t)(W - 1) * L, stride, col);
  Fe ay = taiga::load_fe(wy + (int64_t)(W - 1) * L, stride, col);
  Fe az = taiga::load_fe(wz + (int64_t)(W - 1) * L, stride, col);
#pragma unroll 1
  for (int w = W - 2; w >= 0; w--) {
    const Fe tx = taiga::load_fe(wx + (int64_t)w * L, stride, col);
    const Fe ty = taiga::load_fe(wy + (int64_t)w * L, stride, col);
    const Fe tz = taiga::load_fe(wz + (int64_t)w * L, stride, col);
#pragma unroll 1
    for (int d = 0; d < doublings; d++) {
      Fe nx, ny, nz;
      taiga::ec_dbl_proj_group<HornerMul>(nx, ny, nz, ax, ay, az, F, s, rank, gmask);
      ax = nx;
      ay = ny;
      az = nz;
    }
    Fe nx, ny, nz;
    taiga::ec_add_proj_group<HornerMul>(nx, ny, nz, ax, ay, az, tx, ty, tz, F, s, rank,
                                             gmask);
    ax = nx;
    ay = ny;
    az = nz;
  }
  if (rank == 0) {
    taiga::store_fe(xo, L, col, ax);
    taiga::store_fe(yo, L, col, ay);
    taiga::store_fe(zo, L, col, az);
  }
}

constexpr int kBwThreads = 256;                             // threads of a bit row's block
constexpr int kBwGroups = kBwThreads / taiga::kGroup;
constexpr int kBwMaxBits = 8;                               // c: the cluster's blocks
constexpr int kBwNodes = 1 << (kBwMaxBits - 1);             // a row's first-level sums

// buckets: (16, L 2^c) limb-major, bucket j of column l at lane l 2^c + j;
// one: the identity's y (16, 1); out: (16, L). A cluster of c blocks a
// column (grid (c L), cluster (c, 1, 1)): block t reduces bit row t (lane
// j: B_j where bit t of j is set, else the identity (0 : one : 0)) by the
// aligned tree, its first level from device memory into node[k] = lanes
// 2k + 2k + 1, each later level in place (node[i] += node[i + w] at i a
// multiple of 2w); then block 0 gathers the c row sums from the cluster's
// shared memory and one group runs the Horner over the bits, the most
// significant first.
__global__ void __launch_bounds__(kBwThreads)
k_ec_bucket_weights(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ bz, const uint32_t* __restrict__ one, int c,
                    int64_t L, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                    uint32_t* __restrict__ zo, int field) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ uint32_t node[3 * taiga::kWords][kBwNodes];
  __shared__ taiga::GroupScratch scratch[kBwGroups];
  __shared__ uint32_t sums[kBwMaxBits][3 * taiga::kWords];
  const int tid = threadIdx.x, g = tid / taiga::kGroup, rank = tid % taiga::kGroup;
  const unsigned gmask = taiga::group_mask(tid);
  const int bit = (int)cluster.block_rank();
  const int64_t col = blockIdx.x / c;
  const int half = 1 << (c - 1);
  const int64_t stride = L << c, base = col << c;
  const taiga::FieldConsts F = taiga::kFields[field];
  const Fe ident[3] = {Fe{}, taiga::load_fe(one, 1, 0), Fe{}};
  const uint32_t* src[3] = {bx, by, bz};
  for (int pass = 0; pass < half; pass += kBwGroups) {
    const int k = pass + g;
    if (k >= half) break;  // the group leaves together
    Fe p[2][3];
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int j = 2 * k + h;
#pragma unroll
      for (int v = 0; v < 3; v++) {
        p[h][v] = (j >> bit) & 1 ? taiga::load_fe(src[v], stride, base + j) : ident[v];
      }
    }
    Fe r[3];
    taiga::ec_add_proj_group<WeightMul>(r[0], r[1], r[2], p[0][0], p[0][1], p[0][2],
                                             p[1][0], p[1][1], p[1][2], F, scratch[g], rank,
                                             gmask);
    if (rank == 0) write_pt(node, k, r[0], r[1], r[2]);
  }
  __syncthreads();
  for (int w = 1; w < half; w *= 2) {
    const int adds = half / (2 * w);
    for (int pass = 0; pass < adds; pass += kBwGroups) {
      const int k = pass + g;
      if (k >= adds) break;
      const int i = 2 * w * k;
      Fe a[3], b[3], r[3];
      read_pt(a, node, i);
      read_pt(b, node, i + w);
      taiga::ec_add_proj_group<WeightMul>(r[0], r[1], r[2], a[0], a[1], a[2], b[0], b[1],
                                               b[2], F, scratch[g], rank, gmask);
      if (rank == 0) write_pt(node, i, r[0], r[1], r[2]);
    }
    __syncthreads();
  }
  cluster.sync();  // every row's sum is in its block's node[.][0]
  if (bit == 0) {
    for (int v = tid; v < c * 3 * taiga::kWords; v += kBwThreads) {
      const int row = v / (3 * taiga::kWords), word = v % (3 * taiga::kWords);
      sums[row][word] = cluster.map_shared_rank(&node[word][0], row)[0];
    }
  }
  cluster.sync();  // block 0 holds the sums: the others may leave
  if (bit != 0 || g != 0) return;
  Fe acc[3], term[3];
  auto load_sum = [&](Fe (&p)[3], int row) {
#pragma unroll
    for (int v = 0; v < 3; v++) {
#pragma unroll
      for (int w = 0; w < taiga::kWords; w++) p[v].w[w] = sums[row][v * taiga::kWords + w];
    }
  };
  load_sum(acc, c - 1);
#pragma unroll 1
  for (int b = c - 2; b >= 0; b--) {
    Fe d[3];
    taiga::ec_dbl_proj_group<WeightMul>(d[0], d[1], d[2], acc[0], acc[1], acc[2], F,
                                             scratch[0], rank, gmask);
    load_sum(term, b);
    taiga::ec_add_proj_group<WeightMul>(acc[0], acc[1], acc[2], d[0], d[1], d[2], term[0],
                                             term[1], term[2], F, scratch[0], rank, gmask);
  }
  if (rank == 0) {
    taiga::store_fe(xo, L, col, acc[0]);
    taiga::store_fe(yo, L, col, acc[1]);
    taiga::store_fe(zo, L, col, acc[2]);
  }
}

}  // namespace

extern "C" int taiga_ec_add_proj(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                 const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                 uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_add_proj<<<(unsigned)blocks, threads, 0, stream>>>(x1, y1, z1, x2, y2, z2, xo, yo, zo, B,
                                                          field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_ec_add_proj_sel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                     const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                     const uint32_t* sel, uint32_t* xo, uint32_t* yo,
                                     uint32_t* zo, int64_t B, int field, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kSelLanes - 1) / kSelLanes;
  k_ec_add_sel<<<(unsigned)blocks, kSelLanes, 0, stream>>>(x1, y1, z1, x2, y2, z2, sel,
                                                                    xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}

// The rounds r < rounds over B / n rows of n lanes in one cooperative
// launch; off (B int32) and counts (rounds int32) are scratch.
extern "C" int taiga_ec_seg_rows(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                 const int64_t* keys, int64_t n, int rounds, uint32_t* xo,
                                 uint32_t* yo, uint32_t* zo, int32_t* off, int32_t* counts,
                                 int64_t B, int field, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n <= 0 || B % n != 0 || rounds < 0 || rounds > 62) return (int)cudaErrorInvalidValue;
  static int resident = 0;  // blocks the card holds at once: a cooperative grid's limit
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_ec_seg_rows, kSelLanes, 0);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int64_t want = (B + kSelLanes - 1) / kSelLanes;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  void* args[] = {&x, &y, &z, &keys, &n, &rounds, &xo, &yo, &zo, &off, &counts, &B, &field};
  return (int)cudaLaunchCooperativeKernel((const void*)k_ec_seg_rows, dim3(blocks),
                                          dim3(kSelLanes), args, 0, stream);
}

// Rounds 0 .. rounds-1 over tiles of `tile` lanes in one launch.
extern "C" int taiga_ec_seg_tile(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                 const int64_t* keys, int tile, int rounds, uint32_t* xo,
                                 uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  if (tile <= 0 || tile > kSelLanes || (tile & (tile - 1)) != 0 || B % tile != 0 ||
      rounds < 0 || (1 << rounds) > tile)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;  // above 48 KB, dynamic shared memory is opt-in
  if (!sized) {
    const cudaError_t rc = cudaFuncSetAttribute(
        k_ec_seg_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
    if (rc != cudaSuccess) return (int)rc;
    sized = true;
  }
  const int64_t blocks = (B + kTileBlock - 1) / kTileBlock;
  k_ec_seg_tile<<<(unsigned)blocks, kSelLanes, kTileSmem, stream>>>(x, y, z, keys, tile, rounds,
                                                                    xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_ec_horner(const uint32_t* wx, const uint32_t* wy, const uint32_t* wz,
                               uint32_t* xo, uint32_t* yo, uint32_t* zo, int W, int64_t L,
                               int doublings, int field, cudaStream_t stream) {
  if (L <= 0) return 0;
  if (W <= 0 || doublings < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (L + kHornerCols - 1) / kHornerCols;
  k_ec_horner<<<(unsigned)blocks, kHornerThreads, 0, stream>>>(wx, wy, wz, xo, yo, zo, W, L,
                                                              doublings, field);
  return (int)cudaGetLastError();
}

// sum_j j B_j a column over L columns of 2^c buckets (1 <= c <= 8), one
// launch of L clusters of c blocks on the grid's first axis.
extern "C" int taiga_ec_bucket_weights(const uint32_t* bx, const uint32_t* by,
                                       const uint32_t* bz, const uint32_t* one, int c,
                                       int64_t L, uint32_t* xo, uint32_t* yo, uint32_t* zo,
                                       int field, cudaStream_t stream) {
  if (L <= 0) return 0;
  if (c < 1 || c > kBwMaxBits || L > 0x7FFFFFFF / c) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c * L), 1, 1);
  cfg.blockDim = dim3(kBwThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, k_ec_bucket_weights, bx, by, bz, one, c, L, xo, yo, zo,
                                 field);
}
