// K6 / K7: complete Jacobian point addition over limb-major (16, B)
// coordinates, plain (K6) and with a lane select sel ? P1 + P2 : P1 (K7);
// the Jacobian doubling on its own; K7 chained into the whole
// double-and-add ladder in one launch (ec_ladder); and K6 chained into each
// column's halving tree in one launch (ec_add_tree).
//
// Replaces taiga_tpu/ops/ff_kernels.py::ec_add_lm (K6) and
// ::ec_add_select_lm (K7), core _ec_add_core, the ladders over K7 and the
// doubling of taiga_tpu/ops/ec.py::ec_scalar_mul_shared (:144-161) and
// taiga_tpu/parallel/sharded.py::_local_msm_bitserial (:58-86), and that
// function's halving tree over K6 (:84-89). The doubling
// (taiga_ec_double_jac) replaces no Pallas kernel: it is the XLA program of
// taiga_tpu/ops/ec.py::ec_double (dbl-2009-l), with no case analysis: an
// identity lane (Z = 0) keeps dbl-2009-l's X3, Y3 and gets Z3 = 2YZ = 0,
// as in the reference, where K6(P, P) would return P.
//
// K6, one thread a lane (ec_add_jac below): the general add (16 products),
// then the reference's cases -- the doubling where h = r = 0, Z = 0 where
// h = 0 but r != 0 (P1 = -P2), and the other operand where one of them is
// the identity (Z = 0). The flags come from the canonical Montgomery limbs,
// as in the reference. The doubling (7 products) runs under a branch
// uniform over the warp, taken where any of its lanes has h = r = 0:
// computed on every lane and selected, as before, 30% of the products
// served only such lanes and its values held 168 registers (128 now; K6
// took 1.615 ms at 1,048,576 lanes against 1.014 now, PERF.md section 6;
// K7's group kernel with every lane selected took 1.618). 6 coalesced
// inputs, 3 outputs: bound by operations.
//
// ec_add_tree: the bitserial MSM sums each column's n ladder outputs by the
// reference's halving tree (lane i + lane i + n / 2, a level at a time;
// Jacobian coordinates are not canonical, so no other pairing gives the
// reference's bits). That was log2 n dependent K6 launches, each one add's
// latency on a few blocks, paced by the host, and 6 copies of half-columns
// a level. Here one block sums a column: the first level reads the points
// from device memory, every sum stays in shared memory (n / 2 points x 96
// bytes, dynamic shared memory above 48 KB), a block barrier separates the
// levels, and the adds run on K7's group core (8 threads an add, the
// doubling only in a group whose lane needs it). One thread an add took
// 0.321 ms at 2 x 1,024 against 0.273 for the groups: the narrow levels,
// where a chain of 16 products is the latency, dominate (PERF.md section
// 6). A column of more than kTreeMaxN = 4,096 points (its first level's
// 2,048 sums fill 192 KB of shared memory) first runs K6 launches, a level
// each, in the wrapper. What bounds it: one chain of log2 n dependent adds
// (5 product stages each), on C SMs.
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

// The general add (16 products), and the doubling (7) only where a lane of
// the warp needs it: `mask` holds the warp's threads that run this add
// together.
__device__ __forceinline__ void ec_add_jac(taiga::Fe& xo, taiga::Fe& yo, taiga::Fe& zo,
                                           const taiga::Fe& x1, const taiga::Fe& y1,
                                           const taiga::Fe& z1, const taiga::Fe& x2,
                                           const taiga::Fe& y2, const taiga::Fe& z2,
                                           const taiga::FieldConsts& F, unsigned mask) {
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
  xo = fe_sub(fe_sub(r2, hhh, F), fe_add(v, v, F), F);
  yo = fe_sub(fe_mul(r, fe_sub(v, xo, F), F), fe_mul(s1, hhh, F), F);
  zo = fe_mul(fe_mul(z1, z2, F), h, F);

  const bool p_inf = fe_is_zero(z1);
  const bool q_inf = fe_is_zero(z2);
  const bool h_zero = fe_is_zero(h);
  const bool both = !p_inf && !q_inf;
  const bool is_double = both && h_zero && fe_is_zero(r);
  if (both && h_zero && !is_double) zo = Fe{};  // P1 = -P2
  if (__any_sync(mask, is_double)) {  // dbl-2009-l of P1, uniform over the warp
    Fe dx, dy, dz;
    ec_double_jac(dx, dy, dz, x1, y1, z1, F);
    if (is_double) {
      xo = dx;
      yo = dy;
      zo = dz;
    }
  }
  xo = p_inf ? x2 : (q_inf ? x1 : xo);
  yo = p_inf ? y2 : (q_inf ? y1 : yo);
  zo = p_inf ? z2 : (q_inf ? z1 : zo);
}

__global__ void k_ec_add_jac(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                             const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                             const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                             uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                             uint32_t* __restrict__ zo, int64_t B, int field) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned wmask = __ballot_sync(0xFFFFFFFFu, lane < B);  // the warp's live lanes
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  taiga::Fe ax = taiga::load_fe(x1, B, lane);
  taiga::Fe ay = taiga::load_fe(y1, B, lane);
  taiga::Fe az = taiga::load_fe(z1, B, lane);
  taiga::Fe bx = taiga::load_fe(x2, B, lane);
  taiga::Fe by = taiga::load_fe(y2, B, lane);
  taiga::Fe bz = taiga::load_fe(z2, B, lane);
  taiga::Fe rx, ry, rz;
  ec_add_jac(rx, ry, rz, ax, ay, az, bx, by, bz, F, wmask);
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

// --- ec_add_tree: each column's halving tree in one launch -----------------

constexpr int kTreeThreads = 256;
constexpr int64_t kTreeMaxN = 4096;  // a column's points a block takes (it holds n / 2)

// A point of the tree's shared memory: coordinate k (x, y, z) of point i,
// word j at [(k * 8 + j) * cap + i], so a warp's neighbouring points are
// neighbouring words.
__device__ __forceinline__ Fe tree_load(const uint32_t* sm, int64_t cap, int k, int64_t i) {
  Fe r;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) r.w[j] = sm[(k * taiga::kWords + j) * cap + i];
  return r;
}

__device__ __forceinline__ void tree_store(uint32_t* sm, int64_t cap, int k, int64_t i,
                                           const Fe& a) {
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) sm[(k * taiga::kWords + j) * cap + i] = a.w[j];
}

// Block c sums column c, points c * n .. c * n + n - 1 of (16, C * n), by
// the reference's halving tree: at each level of h = n / 2, ..., 1, point
// i < h becomes point i + point i + h (the complete add, P1 = point i). The
// first level reads the points from device memory; its sums and every
// later level's stay in shared memory; block-level barriers separate the
// levels. A level's adds run on the block's 32 groups of 8 threads
// (ec_add_jac_group, K7's core: 5 product stages an add).
__global__ void __launch_bounds__(kTreeThreads)
k_ec_add_tree(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, uint32_t* __restrict__ xo,
              uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t n, int64_t C,
              int field) {
  extern __shared__ uint32_t tree[];
  constexpr int kUnits = kTreeThreads / taiga::kGroup;  // adds at a time
  __shared__ taiga::JacScratch scratch[kUnits];
  const int64_t col = blockIdx.x, off = col * n, total = C * n, cap = n / 2;
  const int tid = threadIdx.x;
  const taiga::FieldConsts F = taiga::kFields[field];
  if (n == 1) {
    if (tid == 0) {
      taiga::store_fe(xo, C, col, taiga::load_fe(x, total, off));
      taiga::store_fe(yo, C, col, taiga::load_fe(y, total, off));
      taiga::store_fe(zo, C, col, taiga::load_fe(z, total, off));
    }
    return;
  }
  const int g = tid / taiga::kGroup, rank = tid % taiga::kGroup;
  const unsigned gmask = taiga::group_mask(tid);
  for (int64_t h = cap; h >= 1; h >>= 1) {
    const bool first = h == cap;
    for (int64_t i = g; i < h; i += kUnits) {  // uniform over the group
      Fe p[6];
#pragma unroll
      for (int k = 0; k < 3; k++) {
        const uint32_t* src = k == 0 ? x : (k == 1 ? y : z);
        p[k] = first ? taiga::load_fe(src, total, off + i) : tree_load(tree, cap, k, i);
        p[3 + k] = first ? taiga::load_fe(src, total, off + i + h) : tree_load(tree, cap, k, i + h);
      }
      Fe rx, ry, rz;
      taiga::ec_add_jac_group(rx, ry, rz, p[0], p[1], p[2], p[3], p[4], p[5], F, scratch[g],
                              rank, gmask);
      if (rank == 0) {
        tree_store(tree, cap, 0, i, rx);
        tree_store(tree, cap, 1, i, ry);
        tree_store(tree, cap, 2, i, rz);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    taiga::store_fe(xo, C, col, tree_load(tree, cap, 0, 0));
    taiga::store_fe(yo, C, col, tree_load(tree, cap, 1, 0));
    taiga::store_fe(zo, C, col, tree_load(tree, cap, 2, 0));
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

// The halving tree of each of C columns of n points (16, C * n) -> (16, C);
// n a power of two, at most kTreeMaxN.
extern "C" int taiga_ec_add_tree(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                 uint32_t* xo, uint32_t* yo, uint32_t* zo, int64_t n, int64_t C,
                                 int field, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (n < 1 || n > kTreeMaxN || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      k_ec_add_tree, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(3 * taiga::kWords * sizeof(uint32_t) * (kTreeMaxN / 2)));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = 3 * taiga::kWords * sizeof(uint32_t) * (size_t)(n / 2);
  k_ec_add_tree<<<(unsigned)C, kTreeThreads, smem, stream>>>(x, y, z, xo, yo, zo, n, C, field);
  return (int)cudaGetLastError();
}
