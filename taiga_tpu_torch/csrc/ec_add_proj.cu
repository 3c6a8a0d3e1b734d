// K2 / K3: complete projective point addition over limb-major (16, B)
// coordinates, plain (K2) and with a lane select sel ? P1 + P2 : P1 (K3).
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_proj_lm (K2) and
// ::ec_add_proj_sel_lm (K3), core _ec_add_proj_core (RCB Algorithm 7).
// One thread per lane; 6 (K3: 6 + sel) coalesced limb-major inputs, 3
// outputs. 12 Montgomery products (~1,500 32-bit multiply-adds) per 576
// bytes moved: bound by operations on this card, not bytes. The whole
// formula stays in registers (the fusion the Pallas kernel existed for);
// making the products faster is later work.

#include "field.cuh"

namespace {

template <bool kSel>
__global__ void k_ec_add_proj(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                              const uint32_t* __restrict__ sel, uint32_t* __restrict__ xo,
                              uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B,
                              int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  taiga::Fe ax = taiga::load_fe(x1, B, lane);
  taiga::Fe ay = taiga::load_fe(y1, B, lane);
  taiga::Fe az = taiga::load_fe(z1, B, lane);
  if (kSel && sel[lane] == 0) {
    taiga::store_fe(xo, B, lane, ax);
    taiga::store_fe(yo, B, lane, ay);
    taiga::store_fe(zo, B, lane, az);
    return;
  }
  taiga::Fe bx = taiga::load_fe(x2, B, lane);
  taiga::Fe by = taiga::load_fe(y2, B, lane);
  taiga::Fe bz = taiga::load_fe(z2, B, lane);
  taiga::Fe rx, ry, rz;
  taiga::ec_add_proj(rx, ry, rz, ax, ay, az, bx, by, bz, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
}

}  // namespace

extern "C" int taiga_ec_add_proj(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                 const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                 uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_add_proj<false><<<(unsigned)blocks, threads, 0, stream>>>(
      x1, y1, z1, x2, y2, z2, nullptr, xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_ec_add_proj_sel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                     const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                     const uint32_t* sel, uint32_t* xo, uint32_t* yo,
                                     uint32_t* zo, int64_t B, int field, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_add_proj<true><<<(unsigned)blocks, threads, 0, stream>>>(
      x1, y1, z1, x2, y2, z2, sel, xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}
