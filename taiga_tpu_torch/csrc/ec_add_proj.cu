// K2 / K3: complete projective point addition over limb-major (16, B)
// coordinates, plain (K2) and with a lane select sel ? P1 + P2 : P1 (K3);
// and K2 chained into a Horner evaluation in one launch (ec_horner).
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_proj_lm (K2) and
// ::ec_add_proj_sel_lm (K3), core _ec_add_proj_core (RCB Algorithm 7), and
// the scans over K2 that combine an MSM's window sums
// (taiga_tpu/ops/msm.py:417-424) and weight its buckets by their bits
// (:158-173).
//
// K2 / K3, one thread per lane: 6 (K3: 6 + sel) coalesced limb-major
// inputs, 3 outputs; 12 Montgomery products (~3,200 32-bit multiply-adds)
// per 576 bytes moved, so bound by operations on this card. The whole
// formula stays in registers (the fusion the Pallas kernel existed for) and
// every field operation runs on the hardware's carry chains
// (csrc/field.cuh); at most 128 registers a thread keep 16 warps on an SM
// to hide the products' serial chains, which still hold it at ~2.4x its
// operations bound on an H100. Its bytes bound counts 16-bit limbs stored
// in 32-bit words, twice the values' bytes: the (16, B) int32 contract of
// the module boundaries, which a later design may pack.
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

template <bool kSel>
__global__ void __launch_bounds__(128, 4)
k_ec_add_proj(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
              const uint32_t* __restrict__ sel, uint32_t* __restrict__ xo,
              uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B, int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  Fe ax = taiga::load_fe(x1, B, lane);
  Fe ay = taiga::load_fe(y1, B, lane);
  Fe az = taiga::load_fe(z1, B, lane);
  if (kSel && sel[lane] == 0) {
    taiga::store_fe(xo, B, lane, ax);
    taiga::store_fe(yo, B, lane, ay);
    taiga::store_fe(zo, B, lane, az);
    return;
  }
  Fe bx = taiga::load_fe(x2, B, lane);
  Fe by = taiga::load_fe(y2, B, lane);
  Fe bz = taiga::load_fe(z2, B, lane);
  Fe rx, ry, rz;
  taiga::ec_add_proj(rx, ry, rz, ax, ay, az, bx, by, bz, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
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
