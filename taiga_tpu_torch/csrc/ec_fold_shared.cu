// K5: the IPA generator fold G' = G_lo + [s] G_hi over limb-major (16, B)
// projective coordinates, with ONE 255-bit scalar s shared by every lane.
//
// Replaces taiga_tpu/ops/ff_kernels.py::_ec_fold_shared_jit (reached through
// ec_fold_shared_lm), which runs the whole double-and-add inside one Pallas
// kernel. Step for step its body: acc starts at the identity (0 : 1 : 0);
// for bit i of s, LSB first, acc = bit ? acc + base : acc, then
// base = base + base (complete RCB adds); finally G_lo + acc. The operation
// order fixes which projective representative comes out, so it is kept
// exactly. The scalar is the same for every lane, so the bit test is
// warp-uniform: where the bit is 0 the add is skipped (the reference
// computes it and keeps acc), and the last doubling, whose result is never
// read, is skipped too; the output is the same bit for bit.
//
// What bounds it: a lane is one dependent chain of 254 doublings, ~128 adds
// and the final add, so a launch costs at least one chain's latency (13
// launches a proof, 4,096 lanes down to 1). The design shortens the chain. Each lane has 16 threads, two groups of
// csrc/ec_group.cuh side by side in one warp: threads 0-7 compute the add
// acc + base while threads 8-15 compute the doubling base + base, both of
// which read only the previous base, and each group spreads the six
// products of each product stage over its threads. A step then costs two
// product stages (one product's latency each) and the add/sub chains
// around them: the chain is 2 x 255 product stages long, against ~4,600
// products one after another with one thread a lane. The doubling group
// hands the new base to the add group by warp shuffles after each step.
// Blocks are 8 lanes (128 threads), so 4,096 lanes are 512 blocks over
// every SM; at most 128 registers a thread keep four blocks (16 warps) on
// an SM, 528 blocks in one wave. Up to some hundreds of lanes a launch
// costs one chain's latency; at 4,096 lanes the card's instruction issue
// binds it instead, as a group runs its add/sub chains on every thread
// (about 2.4x the instructions of a one-thread add, counted from this
// source).

#include "ec_group.cuh"

namespace {

using taiga::Fe;

constexpr int kLanesPerBlock = 8;
constexpr int kThreadsPerLane = 2 * taiga::kGroup;  // the add group, the doubling group
constexpr int kThreads = kLanesPerBlock * kThreadsPerLane;
constexpr int kSteps = 255;

__global__ void __launch_bounds__(kThreads, 4)
k_ec_fold_shared(const uint32_t* __restrict__ xl, const uint32_t* __restrict__ yl,
                 const uint32_t* __restrict__ zl, const uint32_t* __restrict__ xh,
                 const uint32_t* __restrict__ yh, const uint32_t* __restrict__ zh,
                 const uint32_t* __restrict__ scalar, const uint32_t* __restrict__ one,
                 uint32_t* __restrict__ xo, uint32_t* __restrict__ yo, uint32_t* __restrict__ zo,
                 int64_t B, int field) {
  __shared__ taiga::GroupScratch scratch[kThreads / taiga::kGroup];
  __shared__ uint32_t bits[taiga::kLimbs];
  const int tid = threadIdx.x;
  if (tid < taiga::kLimbs) bits[tid] = scalar[tid];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * kLanesPerBlock + tid / kThreadsPerLane;
  if (lane >= B) return;  // a lane's 16 threads leave together
  const int rank = tid % taiga::kGroup;
  const bool doubler = (tid / taiga::kGroup) & 1;
  const unsigned gmask = taiga::group_mask(tid);
  const unsigned lmask = 0xFFFFu << (tid & 16);  // the lane's 16 threads in the warp
  const int partner = (tid & 16) | taiga::kGroup | rank;  // same rank in the doubling group
  taiga::GroupScratch& s = scratch[tid / taiga::kGroup];
  const taiga::FieldConsts F = taiga::kFields[field];

  Fe ax = {}, az = {};
  Fe ay = taiga::load_fe(one, 1, 0);
  Fe bx = taiga::load_fe(xh, B, lane);
  Fe by = taiga::load_fe(yh, B, lane);
  Fe bz = taiga::load_fe(zh, B, lane);
#pragma unroll 1
  for (int i = 0; i < kSteps; i++) {
    const bool run = doubler ? i + 1 < kSteps : (bits[i >> 4] >> (i & 15)) & 1u;
    if (run) {  // the add group: acc + base; the doubling group: base + base
      Fe nx, ny, nz;
      taiga::ec_add_proj_group(nx, ny, nz, taiga::fe_sel(doubler, bx, ax),
                               taiga::fe_sel(doubler, by, ay), taiga::fe_sel(doubler, bz, az),
                               bx, by, bz, F, s, rank, gmask);
      if (doubler) {
        bx = nx;
        by = ny;
        bz = nz;
      } else {
        ax = nx;
        ay = ny;
        az = nz;
      }
    }
#pragma unroll
    for (int j = 0; j < taiga::kWords; j++) {  // every thread takes the doubled base
      bx.w[j] = __shfl_sync(lmask, bx.w[j], partner);
      by.w[j] = __shfl_sync(lmask, by.w[j], partner);
      bz.w[j] = __shfl_sync(lmask, bz.w[j], partner);
    }
  }
  if (doubler) return;
  Fe lx = taiga::load_fe(xl, B, lane);
  Fe ly = taiga::load_fe(yl, B, lane);
  Fe lz = taiga::load_fe(zl, B, lane);
  Fe rx, ry, rz;
  taiga::ec_add_proj_group(rx, ry, rz, lx, ly, lz, ax, ay, az, F, s, rank, gmask);
  if (rank == 0) {
    taiga::store_fe(xo, B, lane, rx);
    taiga::store_fe(yo, B, lane, ry);
    taiga::store_fe(zo, B, lane, rz);
  }
}

}  // namespace

// scalar: 16 plain 16-bit limbs (one per 32-bit word); one: the 16 limbs of
// 1 in Montgomery form (the Y of the identity).
extern "C" int taiga_ec_fold_shared(const uint32_t* xl, const uint32_t* yl, const uint32_t* zl,
                                    const uint32_t* xh, const uint32_t* yh, const uint32_t* zh,
                                    const uint32_t* scalar, const uint32_t* one, uint32_t* xo,
                                    uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                    cudaStream_t stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  k_ec_fold_shared<<<(unsigned)blocks, kThreads, 0, stream>>>(xl, yl, zl, xh, yh, zh, scalar,
                                                              one, xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}
