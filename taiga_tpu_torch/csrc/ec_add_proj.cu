// K2 / K3: complete projective point addition over limb-major (16, B)
// coordinates, plain (K2) and with a lane select sel ? P1 + P2 : P1 (K3);
// K3 chained into the segmented Hillis-Steele rounds of the MSMs
// (ec_seg_round, one launch a round; ec_seg_tile, every round of a tile in
// one launch); and K2 chained into a Horner evaluation in one launch
// (ec_horner).
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_proj_lm (K2) and
// ::ec_add_proj_sel_lm (K3), core _ec_add_proj_core (RCB Algorithm 7), the
// rounds over K3 of taiga_tpu/ops/msm.py::_seg_rounds (:74-88), and the
// scans over K2 that combine an MSM's window sums (:417-424) and weight its
// buckets by their bits (:158-173).
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
// K3 and the rounds: a lane whose select is 0 only copies P1, so with one
// thread a lane a warp paid the whole add whenever any of its 32 lanes was
// selected -- with scattered selections nearly every warp. Here a block of
// 128 lanes stages P1 (and P2 where selected) in shared memory with
// coalesced loads, lists its selected lanes (a ballot and a popcount a
// warp, a prefix over the four warps), and thread t < count adds lane
// list[t] there; the block writes its lanes back coalesced. The SM's
// instruction slots go to selected adds only, and no add touches device
// memory out of order. A launch still costs about one add's latency a wave
// of resident blocks (4 an SM at 128 registers), however few lanes a block
// selects: tools/torch_k3_waves.py shows the time step up where a fifth
// block an SM is needed, and over several waves one lane in 128 costs
// about nine tenths of all 128 (PERF.md section 6). So compaction pays at
// middling selections, not at sparse ones. Blocks of 512 lanes whose
// threads take their listed lanes straight from device memory (gathers and
// scatters of 16 rows each) measured faster only at one lane in 32, and
// slower at half and on the narrow rounds, which then fill fewer SMs. A
// round computes its select in the kernel from int64 keys, same =
// (i mod n) + s < n && key[i] == key[i + s], and reads its neighbour at
// lane i + s: no rolled copies and no mask tensor.
// ec_seg_tile runs every round over tiles of <= 128 lanes in one launch: a
// block packs 512 lanes into shared memory (8 words a coordinate, 96 B a
// point, 48 KB), runs the rounds there, a tile's edges counting as run
// edges, adding each round's selected lanes 128 at a time, and writes the
// result once: one launch where one a round takes seven, which keeps a
// proof's K3-family launches at 119 (167 with a launch a round).
//
// ec_horner: acc = term[W-1]; for w = W-2 .. 0: `doublings` times
// acc = acc + acc, then acc = acc + term[w]. The MSMs run it over one or a
// few columns (their window sums, or their bits), so each column is one
// chain of up to 279 dependent adds: bound by the chain's latency, not by
// the card's width. One launch runs the whole chain, with each add computed
// by a group of 8 threads (csrc/ec_group.cuh, two product stages of one
// product's latency each), where one K2 launch per add paid the host's
// launch and a single thread's twelve products.

#include "ec_group.cuh"

namespace {

using taiga::Fe;

constexpr int kSelLanes = 128;  // lanes (and threads) of a K3 / round / tile block
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

// lane i <- sel(i) ? P1[i] + P2[i + off] : P1[i] over one block of
// kSelLanes lanes (P2 may be P1: a round). The block stages P1, and P2
// where it is selected, in shared memory with coalesced loads, lists its
// selected lanes, and thread t < count adds lane list[t] from shared memory
// into P1's copy; the block then writes its lanes back coalesced. Adds run
// in full warps (only the last busy one partly filled) and touch device
// memory only through coalesced rows.
template <class Sel>
__device__ __forceinline__ void add_sel_block(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2, int64_t off, Sel sel,
    uint32_t* __restrict__ xo, uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B,
    int field) {
  __shared__ uint32_t p1[3 * taiga::kWords][kSelLanes], p2[3 * taiga::kWords][kSelLanes];
  __shared__ uint8_t list[kSelLanes];
  __shared__ int warp_count[kSelWarps];
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * kSelLanes + t;
  const bool pred[1] = {lane < B && sel(lane)};
  const uint8_t value[1] = {(uint8_t)t};
  if (lane < B) pack_lane(p1, t, x1, y1, z1, B, lane);
  if (pred[0]) pack_lane(p2, t, x2, y2, z2, B, lane + off);
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

struct SelMask {
  const uint32_t* sel;
  __device__ bool operator()(int64_t lane) const { return sel[lane] != 0; }
};

struct SelRun {  // lane i + s in its row of n lanes, with the same key
  const int64_t* keys;
  int64_t s, n;
  __device__ bool operator()(int64_t lane) const {
    return lane % n + s < n && keys[lane] == keys[lane + s];
  }
};

// K3: sel ? P1 + P2 : P1, lane-wise.
__global__ void __launch_bounds__(kSelLanes, 4)
k_ec_add_sel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
             const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
             const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
             const uint32_t* __restrict__ sel, uint32_t* __restrict__ xo,
             uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B, int field) {
  add_sel_block(x1, y1, z1, x2, y2, z2, 0, SelMask{sel}, xo, yo, zo, B, field);
}

// One segmented round over rows of n lanes: lane i <- i + s in its row with
// the same key ? P[i] + P[i + s] : P[i].
__global__ void __launch_bounds__(kSelLanes, 4)
k_ec_seg_round(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               const uint32_t* __restrict__ z, const int64_t* __restrict__ keys, int64_t s,
               int64_t n, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
               uint32_t* __restrict__ zo, int64_t B, int field) {
  add_sel_block(x, y, z, x, y, z, s, SelRun{keys, s, n}, xo, yo, zo, B, field);
}

constexpr int kTileSub = 4;                         // sub-blocks of a tile block
constexpr int kTileBlock = kTileSub * kSelLanes;    // lanes of a tile block
constexpr size_t kTileSmem = (size_t)kTileBlock * (3 * taiga::kWords * 4 + 8 + 2)
                             + kTileSub * kSelWarps * 4;

// Every round r < rounds (s = 2^r) of the segmented reduction over tiles of
// `tile` lanes (a power of two dividing kSelLanes; B a multiple of tile).
// A block holds kTileBlock lanes in shared memory: the points, then the
// int64 keys, the round's list and the warp counts. A round lists its
// selected lanes in ascending order and adds them kSelLanes at a time: a
// pass reads only lanes above every lane an earlier pass of the round
// wrote, so one copy of the points serves the whole round.
__global__ void __launch_bounds__(kSelLanes, 4)
k_ec_seg_tile(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, const int64_t* __restrict__ keys, int tile,
              int rounds, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
              uint32_t* __restrict__ zo, int64_t B, int field) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rows<kTileBlock> pts = reinterpret_cast<Rows<kTileBlock>>(smem);
  int64_t* key = reinterpret_cast<int64_t*>(pts + 3 * taiga::kWords);
  uint16_t* list = reinterpret_cast<uint16_t*>(key + kTileBlock);
  int* warp_count = reinterpret_cast<int*>(list + kTileBlock);
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTileBlock;
#pragma unroll
  for (int q = 0; q < kTileSub; q++) {
    const int i = q * kSelLanes + t;
    if (base + i < B) {
      pack_lane(pts, i, x, y, z, B, base + i);
      key[i] = keys[base + i];
    }
  }
  __syncthreads();
  const taiga::FieldConsts F = taiga::kFields[field];
  for (int r = 0; r < rounds; r++) {
    const int s = 1 << r;
    bool pred[kTileSub];
    uint16_t value[kTileSub];
#pragma unroll
    for (int q = 0; q < kTileSub; q++) {
      const int i = q * kSelLanes + t;
      value[q] = (uint16_t)i;
      pred[q] = base + i < B && (i & (tile - 1)) + s < tile && key[i] == key[i + s];
    }
    const int count = compact_block<kTileSub>(pred, value, list, warp_count);
    for (int pass = 0; pass < count; pass += kSelLanes) {
      const bool busy = pass + t < count;
      const int i = busy ? list[pass + t] : 0;
      Fe a[3], b[3];
      if (busy) read_pt(b, pts, i + s);
      __syncthreads();  // the pass reads its neighbours before it writes
      if (busy) {  // lane i is written by this thread alone
        Fe r[3];
        read_pt(a, pts, i);
        taiga::ec_add_proj(r[0], r[1], r[2], a[0], a[1], a[2], b[0], b[1], b[2], F);
        write_pt(pts, i, r[0], r[1], r[2]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int q = 0; q < kTileSub; q++) {
    const int i = q * kSelLanes + t;
    if (base + i < B) unpack_lane(pts, i, xo, yo, zo, B, base + i);
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
      taiga::ec_add_proj_group(nx, ny, nz, ax, ay, az, ax, ay, az, F, s, rank, gmask);
      ax = nx;
      ay = ny;
      az = nz;
    }
    Fe nx, ny, nz;
    taiga::ec_add_proj_group(nx, ny, nz, ax, ay, az, tx, ty, tz, F, s, rank, gmask);
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

// One round (s = 2^r) of the segmented reduction over B / n rows of n lanes.
extern "C" int taiga_ec_seg_round(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                  const int64_t* keys, int64_t s, int64_t n, uint32_t* xo,
                                  uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                  cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n <= 0 || B % n != 0 || s <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (B + kSelLanes - 1) / kSelLanes;
  k_ec_seg_round<<<(unsigned)blocks, kSelLanes, 0, stream>>>(x, y, z, keys, s, n, xo,
                                                                      yo, zo, B, field);
  return (int)cudaGetLastError();
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
