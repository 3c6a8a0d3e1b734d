// K6 / K7: complete Jacobian point addition over limb-major (16, B)
// coordinates, plain (K6) and with a lane select sel ? P1 + P2 : P1 (K7);
// the Jacobian doubling on its own; and K7 chained into the whole
// double-and-add ladder in one launch (ec_ladder).
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_lm (K6) and
// ::ec_add_select_lm (K7), core _ec_add_core, and the ladders over K7 and
// the doubling of taiga_tpu/ops/ec.py::ec_scalar_mul_shared (:144-161) and
// taiga_tpu/parallel/sharded.py::_local_msm_bitserial (:58-86). The
// doubling (taiga_ec_double_jac) replaces no Pallas kernel: it is the XLA
// program of taiga_tpu/ops/ec.py::ec_double (dbl-2009-l), with no case
// analysis: an identity lane (Z = 0) keeps dbl-2009-l's X3, Y3 and gets
// Z3 = 2YZ = 0, as in the reference, where K6(P, P) would return P.
//
// K6, one thread a lane (ec_add_jac below): the general add (16 products)
// and the doubling (7) both computed, then selected in the reference's
// order -- the doubling where h = r = 0, Z = 0 where h = 0 but r != 0
// (P1 = -P2), and the other operand where one of them is the identity
// (Z = 0). The flags come from the canonical Montgomery limbs, as in the
// reference. 6 coalesced inputs, 3 outputs: bound by operations.
//
// The doubling, one thread a lane (ec_double_jac below): 7 products. Its
// group form (3 stages on 8 threads) took 4x the time at 1,048,576 lanes
// (PERF.md section 6); the group doubling runs only beside the add, in
// jac_head.
//
// K7 runs on the Jacobian core of csrc/ec_group.cuh, one lane a group of 8
// threads: a lane's products run a stage at a time (5 stages) instead of
// one after another in one thread, and it computes the doubling of P1 only
// in a group whose lane has h = r = 0. K7 leaves P1 as it is where sel is
// 0.
//
// ec_ladder: per lane, acc = (0, 0, 0); for bit i of the lane's scalar,
// LSB first, acc = bit ? acc + base : acc (the complete add), then, except
// after the last bit, base = 2 base. The ladders of ec_scalar_mul_shared
// and of the bitserial MSM were 255 K7 launches and 254 doubling launches,
// each one add's latency on a few blocks, paced by the host. Here one
// launch runs the whole ladder, acc and base in registers throughout: a
// lane is one group of 8 threads that runs each step's add and doubling
// side by side in the same product stages (jac_head: 6, 7 and 5 products,
// then the add's tail: 3 and 2), so a step costs 5 product stages where
// the add runs and 3 where it is skipped. The 4 groups of a warp run their
// stages together: the add's tail runs where any of the warp's lanes takes
// the add (a lane whose bit is 0 keeps acc), and is skipped where none
// does -- with a scalar shared by every lane, at every 0 bit, as in K5.
// What bounds it: one chain of up to 255 x 5 product stages a lane, so a
// launch costs at least a chain's latency; the bitserial MSM's C columns
// each redo their points' doublings (the work of C x n lanes), which at
// its widths costs no latency (PERF.md section 6).

#include "ec_group.cuh"

namespace {

using taiga::Fe;

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
  using taiga::fe_is_zero;
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

__global__ void k_ec_add_jac(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                             const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                             const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                             uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                             uint32_t* __restrict__ zo, int64_t B, int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  taiga::Fe ax = taiga::load_fe(x1, B, lane);
  taiga::Fe ay = taiga::load_fe(y1, B, lane);
  taiga::Fe az = taiga::load_fe(z1, B, lane);
  taiga::Fe bx = taiga::load_fe(x2, B, lane);
  taiga::Fe by = taiga::load_fe(y2, B, lane);
  taiga::Fe bz = taiga::load_fe(z2, B, lane);
  taiga::Fe rx, ry, rz;
  ec_add_jac(rx, ry, rz, ax, ay, az, bx, by, bz, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
}

// --- the Jacobian core's kernels: one lane a group of kGroup threads ---------

constexpr int kJacThreads = 128;
constexpr int kJacLanes = kJacThreads / taiga::kGroup;  // lanes a block

__global__ void __launch_bounds__(kJacThreads)
k_jac_add_select(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                 const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                 const uint32_t* __restrict__ sel, uint32_t* __restrict__ xo,
                 uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B, int field) {
  __shared__ taiga::JacScratch scratch[kJacLanes];
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * kJacLanes + tid / taiga::kGroup;
  if (lane >= B) return;  // a lane's group leaves together
  const int rank = tid % taiga::kGroup;
  const unsigned gmask = taiga::group_mask(tid);
  const taiga::FieldConsts F = taiga::kFields[field];
  Fe rx = taiga::load_fe(x1, B, lane);
  Fe ry = taiga::load_fe(y1, B, lane);
  Fe rz = taiga::load_fe(z1, B, lane);
  if (sel[lane] != 0) {  // uniform over the group
    const Fe ax = rx, ay = ry, az = rz;
    const Fe bx = taiga::load_fe(x2, B, lane);
    const Fe by = taiga::load_fe(y2, B, lane);
    const Fe bz = taiga::load_fe(z2, B, lane);
    taiga::ec_add_jac_group(rx, ry, rz, ax, ay, az, bx, by, bz, F,
                            scratch[tid / taiga::kGroup], rank, gmask);
  }
  if (rank == 0) {
    taiga::store_fe(xo, B, lane, rx);
    taiga::store_fe(yo, B, lane, ry);
    taiga::store_fe(zo, B, lane, rz);
  }
}

__global__ void k_ec_double_jac(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1, uint32_t* __restrict__ xo,
                                uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t B,
                                int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  Fe ax = taiga::load_fe(x1, B, lane);
  Fe ay = taiga::load_fe(y1, B, lane);
  Fe az = taiga::load_fe(z1, B, lane);
  Fe rx, ry, rz;
  ec_double_jac(rx, ry, rz, ax, ay, az, F);
  taiga::store_fe(xo, B, lane, rx);
  taiga::store_fe(yo, B, lane, ry);
  taiga::store_fe(zo, B, lane, rz);
}

// base: (16, n); scalars: the 16 plain 16-bit limbs of lane L's scalar at
// sl[L * lane_stride ..] (lane_stride 0: one scalar for every lane); out:
// (16, total), lane L = c * n + i the ladder of base lane i = L mod n.
__global__ void __launch_bounds__(kJacThreads)
k_jac_ladder(const uint32_t* __restrict__ bxs, const uint32_t* __restrict__ bys,
             const uint32_t* __restrict__ bzs, const uint32_t* __restrict__ sl,
             int64_t lane_stride, int bits, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
             uint32_t* __restrict__ zo, int64_t n, int64_t total, int field) {
  __shared__ taiga::JacScratch scratch[kJacLanes];
  __shared__ uint32_t words[kJacLanes][taiga::kWords];  // a lane's scalar, 32 bits a word
  const int tid = threadIdx.x;
  const int g = tid / taiga::kGroup;
  const int64_t lane = (int64_t)blockIdx.x * kJacLanes + g;
  const unsigned wmask = __ballot_sync(0xFFFFFFFFu, lane < total);  // the warp's live lanes
  if (lane >= total) return;
  const int rank = tid % taiga::kGroup;
  taiga::JacScratch& s = scratch[g];
  const taiga::FieldConsts F = taiga::kFields[field];
  const uint32_t* limbs = sl + lane * lane_stride;
  words[g][rank] = limbs[2 * rank] | (limbs[2 * rank + 1] << 16);  // kGroup == kWords
  __syncwarp(wmask);

  const int64_t i0 = lane % n;
  Fe ax = {}, ay = {}, az = {};
  Fe bx = taiga::load_fe(bxs, n, i0);
  Fe by = taiga::load_fe(bys, n, i0);
  Fe bz = taiga::load_fe(bzs, n, i0);
  // The warp's groups run every product stage together (their barriers
  // take the warp's mask): a stage runs where any lane of the warp needs
  // it, and a lane that does not keeps its values.
#pragma unroll 1
  for (int i = 0; i < bits; i++) {
    const bool bit = (words[g][i >> 5] >> (i & 31)) & 1u;
    const bool dbl = i + 1 < bits;
    const bool p_inf = taiga::fe_is_zero(az), q_inf = taiga::fe_is_zero(bz);
    const bool general = bit && !p_inf && !q_inf;
    Fe nx = ax, ny = ay, nz = az;  // acc + base: acc where base is the identity,
    if (bit && p_inf) {            // base where acc is
      nx = bx;
      ny = by;
      nz = bz;
    }
    if (__any_sync(wmask, general || dbl)) {
      taiga::JacAddHead head;
      Fe dx, dy, dz;
      taiga::jac_head<true, true>(head, dx, dy, dz, ax, ay, az, bx, by, bz, bx, by, bz, F, s,
                                  rank, wmask);
      if (__any_sync(wmask, general)) {
        Fe tx, ty, tz;
        taiga::jac_add_finish(tx, ty, tz, head, ax, ay, az, general, F, s, rank, wmask);
        if (general) {
          nx = tx;
          ny = ty;
          nz = tz;
        }
      }
      if (dbl) {
        bx = dx;
        by = dy;
        bz = dz;
      }
    }
    ax = nx;
    ay = ny;
    az = nz;
  }
  if (rank == 0) {
    taiga::store_fe(xo, total, lane, ax);
    taiga::store_fe(yo, total, lane, ay);
    taiga::store_fe(zo, total, lane, az);
  }
}

int64_t group_blocks(int64_t lanes) { return (lanes + kJacLanes - 1) / kJacLanes; }

}  // namespace

extern "C" int taiga_ec_add_jac(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t B, int field,
                                cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_ec_add_jac<<<(unsigned)blocks, threads, 0, stream>>>(x1, y1, z1, x2, y2, z2, xo, yo, zo, B,
                                                         field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_ec_add_jac_sel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                    const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                                    const uint32_t* sel, uint32_t* xo, uint32_t* yo,
                                    uint32_t* zo, int64_t B, int field, cudaStream_t stream) {
  if (B <= 0) return 0;
  k_jac_add_select<<<(unsigned)group_blocks(B), kJacThreads, 0, stream>>>(
      x1, y1, z1, x2, y2, z2, sel, xo, yo, zo, B, field);
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

// The ladder over `bits` bits (0 .. 256) of base (16, n), `total` = C * n
// output lanes.
extern "C" int taiga_ec_ladder(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                               const uint32_t* scalars, int64_t lane_stride, int bits,
                               uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t n,
                               int64_t total, int field, cudaStream_t stream) {
  if (total <= 0) return 0;
  if (n <= 0 || total % n != 0 || bits < 0 || bits > 16 * taiga::kLimbs || lane_stride < 0)
    return (int)cudaErrorInvalidValue;
  k_jac_ladder<<<(unsigned)group_blocks(total), kJacThreads, 0, stream>>>(
      bx, by, bz, scalars, lane_stride, bits, xo, yo, zo, n, total, field);
  return (int)cudaGetLastError();
}
