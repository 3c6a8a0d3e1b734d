// K5: the IPA generator fold G' = G_lo + [s] G_hi over limb-major (16, B)
// projective coordinates, with ONE 255-bit scalar s shared by every lane.
//
// Replaces taiga_tpu/ops/ff_kernels.py::_ec_fold_shared_jit (reached through
// ec_fold_shared_lm), which runs the whole double-and-add inside one Pallas
// kernel. Step for step its body: acc starts at the identity (0 : 1 : 0);
// for bit i of s, LSB first, acc = bit ? acc + base : acc, then
// base = base + base (complete RCB adds, csrc/field.cuh ec_add_proj);
// finally G_lo + acc. The operation order fixes which projective
// representative comes out, so it is kept exactly.
//
// One thread per lane. The scalar is the same for every lane, so the bit
// test is warp-uniform: where the bit is 0 the add is skipped (the reference
// computes it and keeps acc), and the last doubling, whose result is never
// read, is skipped too; the output is the same bit for bit.
//
// What bounds it: each lane runs ~255 doublings and ~128 adds, ~4,600
// Montgomery products in ONE dependent chain, against 9 x 64 bytes moved.
// It is bound by operations, and a launch costs about one chain's latency
// whatever its width: at k = 13 the 13 launches of a proof shrink from
// 4,096 lanes (32 blocks of 128: 32 of the 132 SMs) to 1. Spreading a
// lane's chain over several threads, or several folds over the SMs, is
// later work.

#include "field.cuh"

namespace {

__global__ void k_ec_fold_shared(const uint32_t* __restrict__ xl, const uint32_t* __restrict__ yl,
                                 const uint32_t* __restrict__ zl, const uint32_t* __restrict__ xh,
                                 const uint32_t* __restrict__ yh, const uint32_t* __restrict__ zh,
                                 const uint32_t* __restrict__ scalar,
                                 const uint32_t* __restrict__ one, uint32_t* __restrict__ xo,
                                 uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B,
                                 int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  taiga::Fe ax = {}, az = {};
  taiga::Fe ay = taiga::load_fe(one, 1, 0);
  taiga::Fe bx = taiga::load_fe(xh, B, lane);
  taiga::Fe by = taiga::load_fe(yh, B, lane);
  taiga::Fe bz = taiga::load_fe(zh, B, lane);
  constexpr int kSteps = 255;
#pragma unroll 1
  for (int i = 0; i < kSteps; i++) {
    if ((scalar[i >> 4] >> (i & 15)) & 1u) {
      taiga::Fe nx, ny, nz;
      taiga::ec_add_proj(nx, ny, nz, ax, ay, az, bx, by, bz, F);
      ax = nx;
      ay = ny;
      az = nz;
    }
    if (i + 1 < kSteps) {
      taiga::Fe nx, ny, nz;
      taiga::ec_add_proj(nx, ny, nz, bx, by, bz, bx, by, bz, F);
      bx = nx;
      by = ny;
      bz = nz;
    }
  }
  taiga::Fe lx = taiga::load_fe(xl, B, lane);
  taiga::Fe ly = taiga::load_fe(yl, B, lane);
  taiga::Fe lz = taiga::load_fe(zl, B, lane);
  taiga::Fe rx, ry, rz;
  taiga::ec_add_proj(rx, ry, rz, lx, ly, lz, ax, ay, az, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
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
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_fold_shared<<<(unsigned)blocks, threads, 0, stream>>>(xl, yl, zl, xh, yh, zh, scalar, one,
                                                             xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}
