// K6 / K7: complete Jacobian point addition over limb-major (16, B)
// coordinates, plain (K6) and with a lane select sel ? P1 + P2 : P1 (K7);
// and the Jacobian doubling on its own.
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_lm (K6) and
// ::ec_add_select_lm (K7), core _ec_add_core. Step for step the reference:
// the general add (16 products) and the doubling for a = 0 (7 products) are
// both computed, then selected in the reference's order — the doubling
// where h = r = 0, Z = 0 where h = 0 but r != 0 (P1 = -P2), and the other
// operand where one of them is the identity (Z = 0). The flags come from
// is_zero on the canonical Montgomery limbs, as in the reference.
//
// The doubling (taiga_ec_double_jac) replaces no Pallas kernel: it is the
// XLA program of taiga_tpu/ops/ec.py::ec_double (dbl-2009-l), the half of
// K6's core above, with no case analysis: an identity lane (Z = 0) keeps
// dbl-2009-l's X3, Y3 and gets Z3 = 2YZ = 0, as in the reference, where
// K6(P, P) would return P itself.
//
// One thread per lane, 6 (K7: 6 + sel; the doubling: 3) coalesced inputs,
// 3 outputs: 23 products (~6,100 32-bit multiply-adds) per 576 bytes moved
// (the doubling: 7 products per 384 bytes), so bound by operations. K7
// leaves P1 as it is where sel is 0 and skips the formula there. The group
// law of ops/ec.py runs on these: ec_add on K6, each step of
// ec_scalar_mul_shared on K7 and the doubling.

#include "field.cuh"

namespace {

__device__ __forceinline__ bool fe_is_zero(const taiga::Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) acc |= a.w[j];
  return acc == 0;
}

// dbl-2009-l for a = 0: 7 products, no case analysis.
__device__ __forceinline__ void ec_double_jac(taiga::Fe& dx, taiga::Fe& dy, taiga::Fe& dz,
                                              const taiga::Fe& x1, const taiga::Fe& y1,
                                              const taiga::Fe& z1, const taiga::FieldConsts& F) {
  using taiga::Fe;
  using taiga::fe_add;
  using taiga::fe_mul;
  using taiga::fe_sub;
  Fe a_ = fe_mul(x1, x1, F);
  Fe b_ = fe_mul(y1, y1, F);
  Fe c_ = fe_mul(b_, b_, F);
  Fe xb = fe_add(x1, b_, F);
  Fe d_ = fe_sub(fe_sub(fe_mul(xb, xb, F), a_, F), c_, F);
  d_ = fe_add(d_, d_, F);
  Fe e_ = fe_add(fe_add(a_, a_, F), a_, F);
  Fe f_ = fe_mul(e_, e_, F);
  dx = fe_sub(f_, fe_add(d_, d_, F), F);
  Fe c8 = fe_add(fe_add(c_, c_, F), fe_add(c_, c_, F), F);
  c8 = fe_add(c8, c8, F);
  dy = fe_sub(fe_mul(e_, fe_sub(d_, dx, F), F), c8, F);
  Fe yz = fe_mul(y1, z1, F);
  dz = fe_add(yz, yz, F);
}

__device__ __forceinline__ void ec_add_jac(taiga::Fe& xo, taiga::Fe& yo, taiga::Fe& zo,
                                           const taiga::Fe& x1, const taiga::Fe& y1,
                                           const taiga::Fe& z1, const taiga::Fe& x2,
                                           const taiga::Fe& y2, const taiga::Fe& z2,
                                           const taiga::FieldConsts& F) {
  using taiga::Fe;
  using taiga::fe_add;
  using taiga::fe_mul;
  using taiga::fe_sub;
  // general add
  Fe z1z1 = fe_mul(z1, z1, F);
  Fe z2z2 = fe_mul(z2, z2, F);
  Fe u1 = fe_mul(x1, z2z2, F);
  Fe u2 = fe_mul(x2, z1z1, F);
  Fe s1 = fe_mul(y1, fe_mul(z2, z2z2, F), F);
  Fe s2 = fe_mul(y2, fe_mul(z1, z1z1, F), F);
  Fe h = fe_sub(u2, u1, F);
  Fe r = fe_sub(s2, s1, F);
  Fe hh = fe_mul(h, h, F);
  Fe hhh = fe_mul(h, hh, F);
  Fe v = fe_mul(u1, hh, F);
  Fe r2 = fe_mul(r, r, F);
  Fe x3 = fe_sub(fe_sub(r2, hhh, F), fe_add(v, v, F), F);
  Fe y3 = fe_sub(fe_mul(r, fe_sub(v, x3, F), F), fe_mul(s1, hhh, F), F);
  Fe z3 = fe_mul(fe_mul(z1, z2, F), h, F);

  // doubling (a = 0)
  Fe dx, dy, dz;
  ec_double_jac(dx, dy, dz, x1, y1, z1, F);

  const bool p_inf = fe_is_zero(z1);
  const bool q_inf = fe_is_zero(z2);
  const bool h_zero = fe_is_zero(h);
  const bool r_zero = fe_is_zero(r);
  const bool both = !p_inf && !q_inf;
  const bool is_double = both && h_zero && r_zero;
  const bool is_cancel = both && h_zero && !r_zero;

  xo = is_double ? dx : x3;
  yo = is_double ? dy : y3;
  zo = is_double ? dz : z3;
  if (is_cancel) zo = Fe{};
  xo = p_inf ? x2 : (q_inf ? x1 : xo);
  yo = p_inf ? y2 : (q_inf ? y1 : yo);
  zo = p_inf ? z2 : (q_inf ? z1 : zo);
}

template <bool kSel>
__global__ void k_ec_add_jac(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
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
  ec_add_jac(rx, ry, rz, ax, ay, az, bx, by, bz, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
}

__global__ void k_ec_double_jac(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1, uint32_t* __restrict__ xo,
                                uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B,
                                int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  taiga::Fe ax = taiga::load_fe(x1, B, lane);
  taiga::Fe ay = taiga::load_fe(y1, B, lane);
  taiga::Fe az = taiga::load_fe(z1, B, lane);
  taiga::Fe rx, ry, rz;
  ec_double_jac(rx, ry, rz, ax, ay, az, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
}

}  // namespace

extern "C" int taiga_ec_add_jac(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_add_jac<false><<<(unsigned)blocks, threads, 0, stream>>>(x1, y1, z1, x2, y2, z2, nullptr,
                                                                xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_ec_add_jac_sel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                    const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                    const uint32_t* sel, uint32_t* xo, uint32_t* yo,
                                    uint32_t* zo, int64_t B, int field, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_add_jac<true><<<(unsigned)blocks, threads, 0, stream>>>(x1, y1, z1, x2, y2, z2, sel, xo,
                                                               yo, zo, B, field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_ec_double_jac(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                   uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                   cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_double_jac<<<(unsigned)blocks, threads, 0, stream>>>(x1, y1, z1, xo, yo, zo, B, field);
  return (int)cudaGetLastError();
}
