// The permutation and lookup grand products: K8 mont_inv, K9 mont_cumprod
// and K10 perm_terms / lookup_terms.
//
// Replace no Pallas kernel: the JAX package compiles each grand product
// into one XLA program, taiga_tpu/plonk/prover.py::_make_zfn (:310-376)
// and ::_make_lzfn (:434-466), around taiga_tpu/ops/limbs.py::mont_inv
// (:281) and taiga_tpu/ops/poly.py::mont_cumprod (:24). Run eagerly, the
// same math is some 90,000 dispatched torch ops a call, nearly all of them
// the 331 products of one Fermat chain; here it is a few launches.
//
// Layout: element-major (..., 16) rows, the 16 16-bit limbs of an element
// in 16 neighbouring 32-bit words (the module-boundary layout of
// ops/limbs.py), read and written as four 16-byte vectors. Every value is a
// canonical Montgomery element, and field products and sums are exact, so
// any order of association gives the reference's limbs.
//
// K8 mont_inv (taiga_mont_inv: k_mont_inv): the inverse of each of C lanes
// in Montgomery form, 0 -> 0, one thread a lane, by Bernstein and Yang's
// constant-time divsteps ("safegcd", Fast constant-time gcd computation
// and modular inversion, 2019) as libsecp256k1's modinv32 runs them: the
// values in nine signed 30-bit limbs; 20 batches of 30 divsteps on the low
// words of f and g alone, each batch's 2x2 transition matrix then applied
// to (f, g) and, mod p, to (d, e). Then d = +-(aR)^-1 mod p, and one
// product by R^3 mod p (fe_mul_pasta) gives (aR)^-1 R^3 R^-1 = a^-1 R.
// C is 1 to a few dozen, so a call is one thread's chain: 600 divsteps of
// about 17 dependent 32-bit operations, 20 matrix updates and one product,
// where Fermat's a^(p-2) was 329 dependent generic products (0.197 ms on
// the NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6). Constant time on
// purpose (the grand products invert denominators made from the witness):
// a fixed count of iterations, no branch or address that depends on the
// value. Fermat's chain on fe_mul_pasta with a dedicated squaring and a
// fixed 4-bit window, measured beside it, took 0.135-0.137 ms against the
// divsteps' 0.024 (PERF.md section 6) and was removed.
//
// K9 mont_cumprod (taiga_cumprod: k_cumprod_cluster; k_cumprod_totals and
// k_cumprod_apply for a longer row): inclusive prefix products along axis 0
// of an (n, R, 16) view with any element and row strides (the grand
// products pass a moved axis), forward or reverse (suffix products). A row
// of n <= 16,384 is one launch: a cluster of up to 16 blocks (a non-portable
// size), each a tile of 128 threads x `per` neighbours. A thread scans its
// run serially in registers, a warp the runs' totals (shuffles), the block
// its four warps' totals; the block's product goes to shared memory, and
// after one cluster barrier warp 0 multiplies the earlier blocks' products,
// read through distributed shared memory, in a butterfly (no serial loop
// over tiles). A thread's chain is per + 13 products, all on fe_mul_pasta,
// against the two launches and about 33 generic products of the
// tile-totals design before. The host sizes the cluster
// (ff_kernels.cumprod_launch): 4 a thread while the call's blocks number
// two an SM or fewer, where the chain's latency bounds it (a proof's rows
// of 8,192: 16 blocks, a chain of 17); 8 beyond, where the products
// themselves do (a batch's 32 and 40 rows: 8 blocks a row, 22 products a
// thread of 8 in place of 14 of 4, 18% faster at 32 rows). A longer row
// (the cold table build's batch_inv, 262,144) keeps the two passes over
// tiles of 1,024: tile products, then the scan with the earlier tiles'
// product as its carry: 0.062 ms, where the cluster scan window by window
// (16 dependent launches of 16,384, each carrying the last product of the
// window before) took 0.61 (NVIDIA H100 80GB HBM3 at 700 W, PERF.md
// section 6), so the windowed form was not kept.
// The function needs n - 1 products a row; the card is bound by bytes at
// these widths (each element read once, written once).
//
// K9 powers (taiga_powers: k_powers): x^0 .. x^(n-1) of each of R points
// with no scan along the row: every block builds x^j for j <= T (T = 2^t,
// the least power of two with T^2 >= n) and y^k = x^(T k) for k < n / T in
// shared memory by log-depth doubling (each level one product a thread:
// small[m + j] = small[m] small[j]), then writes x^i = big[i >> t] small[i &
// (T - 1)], one product an element, as limbs (poly.powers) or packed words
// (K12's table). log2(n) + 1 dependent products in all; Q n elements
// written, Q read, Q (n - 1) products the function needs.
//
// K10 (taiga_perm_terms, taiga_lookup_terms): the numerators and
// denominators of the grand products, one thread an output element, for
// every proof of a batch in one launch. A permutation chunk's
// prod_j (v_j + beta delta^j omega^i + gamma) and prod_j (v_j + beta
// sigma_j[i] + gamma): a block holds one (proof, chunk) and first forms
// its beta delta^j once in shared memory, so an element costs 4 products a
// column less the chunk's 2 first ones; a lookup's (A + beta)(S + gamma)
// and (A' + beta)(S' + gamma) (2 products). Bound by bytes (each column
// element read once, two elements written).

#include <cooperative_groups.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::load_limbs;
using taiga::shfl_up_fe;
using taiga::shfl_xor_fe;
using taiga::store_limbs;

constexpr int kThreads = 128;           // threads a block of every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                 // K9, a longer row: elements a thread scans
constexpr int kTile = kThreads * kPer;  // K9, a longer row: elements a block
constexpr int kMaxPer = 8;              // K9 in one launch: elements a thread, at most
constexpr int kMaxCluster = 16;         // K9 in one launch: blocks a row, at most
constexpr int kMaxPowLog = 11;          // K9 powers: T = 2^t <= 2,048, so n <= 2^22

// 1 in Montgomery form, 2^256 mod p: 2^256 - p (8 words from 0 - p), less
// p until below it (p > 2^254, so at most three times).
__device__ __forceinline__ Fe fe_one(const FieldConsts& F) {
  Fe r;
  taiga::sub8(r, taiga::fe_zero(), F.p);
#pragma unroll
  for (int k = 0; k < 3; k++) r = taiga::reduce_once(r, 0, F);
  return r;
}

// K9's product: the Montgomery product for the Pasta moduli.
__device__ __forceinline__ Fe mulp(const Fe& a, const Fe& b, const FieldConsts& F) {
  return taiga::fe_mul_pasta(a, b, F);
}

// The product of every thread's x over the block, on every thread (a
// butterfly in each warp, then the warps' products through shared memory).
__device__ Fe block_product(Fe x, Fe* warp_sum, const FieldConsts& F) {
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) x = mulp(x, shfl_xor_fe(x, d), F);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sum[warp] = x;
  __syncthreads();
  Fe r = warp_sum[0];
#pragma unroll 1
  for (int w = 1; w < kWarps; w++) r = mulp(r, warp_sum[w], F);
  __syncthreads();  // warp_sum may be reused
  return r;
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// Divsteps count. Bernstein and Yang's delta = 1 divstep needs at most 741
// steps for inputs below 2^256 (their Theorem 11.2, (49 d + 57) / 17 at d =
// 256). This is the half-delta variant (zeta = -(delta + 1/2), starting at
// delta = 1/2), for which Wuille's hull computation (libsecp256k1's
// doc/safegcd_implementation.md, and its modinv32, which runs 20 x 30 = 600
// steps) bounds the steps at 590 for any f odd and g below 2^256. Both
// Pasta moduli are 255 bits (2^254 < p < 2^255) and g = aR mod p < p, so
// 600 >= 590 suffice on both fields; tests/test_torch_grand_product.py's
// model of this loop checks g = 0 after them on edge and seeded values.
constexpr int kDivBatches = 20;  // batches of 30 divsteps: 600 in all
constexpr int32_t kM30 = 0x3FFFFFFF;
using taiga::kLimbs30;

struct Trans {  // a batch's transition matrix [u v; q r], entries within +-2^30
  int32_t u, v, q, r;
};

// 30 divsteps on the low words f0 (odd) and g0; returns the new zeta.
// Every step is masks and adds: no branch on the value.
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f, uint32_t g, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);  // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);           // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    const uint32_t c3 = c1 & c2;  // swap: zeta < 0 and g odd
    zeta = (zeta ^ (int32_t)c3) - 1;
    f += g & c3;
    u += q & c3;
    v += r & c3;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = Trans{(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// [d, e] = (t [d, e] + p [md, me]) / 2^30, md and me chosen so that the low
// 30 bits vanish (and d, e stay in (-2p, p)).
__device__ __forceinline__ void update_de(int32_t (&d)[kLimbs30], int32_t (&e)[kLimbs30],
                                          const Trans& t, const taiga::InvConsts& V) {
  const int32_t sd = d[kLimbs30 - 1] >> 31, se = e[kLimbs30 - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se), me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
  int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
  md -= (int32_t)((V.pinv30 * (uint32_t)cd + (uint32_t)md) & kM30);
  me -= (int32_t)((V.pinv30 * (uint32_t)ce + (uint32_t)me) & kM30);
  cd += (int64_t)V.p30[0] * md;
  ce += (int64_t)V.p30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < kLimbs30; i++) {
    cd += (int64_t)t.u * d[i] + (int64_t)t.v * e[i] + (int64_t)V.p30[i] * md;
    ce += (int64_t)t.q * d[i] + (int64_t)t.r * e[i] + (int64_t)V.p30[i] * me;
    d[i - 1] = (int32_t)cd & kM30;
    e[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d[kLimbs30 - 1] = (int32_t)cd;
  e[kLimbs30 - 1] = (int32_t)ce;
}

// [f, g] = t [f, g] / 2^30 (exact: the divsteps cleared the low 30 bits).
__device__ __forceinline__ void update_fg(int32_t (&f)[kLimbs30], int32_t (&g)[kLimbs30],
                                          const Trans& t) {
  int64_t cf = (int64_t)t.u * f[0] + (int64_t)t.v * g[0];
  int64_t cg = (int64_t)t.q * f[0] + (int64_t)t.r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < kLimbs30; i++) {
    cf += (int64_t)t.u * f[i] + (int64_t)t.v * g[i];
    cg += (int64_t)t.q * f[i] + (int64_t)t.r * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    g[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f[kLimbs30 - 1] = (int32_t)cf;
  g[kLimbs30 - 1] = (int32_t)cg;
}

// r in (-2p, p), negated when sign < 0, brought to [0, p) with 30-bit limbs:
// add p if negative, negate, carry; add p if still negative, carry.
__device__ __forceinline__ void normalize(int32_t (&r)[kLimbs30], int32_t sign,
                                          const taiga::InvConsts& V) {
  int32_t add = r[kLimbs30 - 1] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < kLimbs30; i++) r[i] = ((r[i] + (V.p30[i] & add)) ^ neg) - neg;
#pragma unroll
  for (int i = 0; i + 1 < kLimbs30; i++) {
    r[i + 1] += r[i] >> 30;
    r[i] &= kM30;
  }
  add = r[kLimbs30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kLimbs30; i++) r[i] += V.p30[i] & add;
#pragma unroll
  for (int i = 0; i + 1 < kLimbs30; i++) {
    r[i + 1] += r[i] >> 30;
    r[i] &= kM30;
  }
}

__global__ void __launch_bounds__(kThreads) k_mont_inv(const uint32_t* __restrict__ a,
                                                       uint32_t* __restrict__ out, int64_t C,
                                                       int field) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const taiga::InvConsts V = taiga::kInv[field];
  const FieldConsts F = kFields[field];
  const Fe x = load_limbs(a + lane * taiga::kLimbs);
  int32_t f[kLimbs30], g[kLimbs30], d[kLimbs30], e[kLimbs30];
#pragma unroll
  for (int i = 0; i < kLimbs30; i++) {  // g = x in 30-bit limbs: bits 30i .. 30i + 29
    const int j = 30 * i / 32, s = 30 * i % 32;
    uint64_t w = x.w[j];
    if (j + 1 < taiga::kWords) w |= (uint64_t)x.w[j + 1] << 32;
    g[i] = (int32_t)((w >> s) & kM30);
    f[i] = V.p30[i];
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < kDivBatches; b++) {
    Trans t;
    zeta = divsteps_30(zeta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de(d, e, t, V);
    update_fg(f, g, t);
  }
  // g = 0 and f = +-1 (gcd(p, x) = 1; f = p for x = 0, where d = 0):
  // d = +-(aR)^-1 mod p
  normalize(d, f[kLimbs30 - 1], V);
  Fe y;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) {  // bits 32j .. 32j + 31 of d: two limbs
    const int k = 32 * j / 30, s = 32 * j % 30;
    y.w[j] = (uint32_t)(((uint64_t)(uint32_t)d[k] >> s) |
                        ((uint64_t)(uint32_t)d[k + 1] << (30 - s)));
  }
  store_limbs(out + lane * taiga::kLimbs, taiga::fe_mul_pasta(y, V.r3, F));
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

struct ScanView {
  const uint32_t* a;
  uint32_t* out;
  int64_t n, a_sn, a_sr, o_sn, o_sr;  // strides in 32-bit words
  int reverse;

  __device__ __forceinline__ int64_t at(int64_t i) const { return reverse ? n - 1 - i : i; }
};

// Pass 1: the product of each tile of each row: totals[(row, tile)].
__global__ void __launch_bounds__(kThreads) k_cumprod_totals(ScanView v, uint32_t* totals,
                                                             int field) {
  __shared__ Fe warp_sum[kWarps];
  const FieldConsts F = kFields[field];
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const int64_t i0 = tile * kTile + (int64_t)threadIdx.x * kPer;
  Fe acc = fe_one(F);
#pragma unroll 1
  for (int k = 0; k < kPer; k++) {
    const int64_t i = i0 + k;
    if (i < v.n) acc = mulp(acc, load_limbs(v.a + v.at(i) * v.a_sn + row * v.a_sr), F);
  }
  const Fe t = block_product(acc, warp_sum, F);
  if (threadIdx.x == 0) {
    uint32_t* dst = totals + (row * gridDim.x + tile) * taiga::kWords;
#pragma unroll
    for (int j = 0; j < taiga::kWords; j++) dst[j] = t.w[j];
  }
}

// Pass 2: the tile's inclusive products, times the product of the row's
// earlier tiles (totals; null when a row is one tile).
__global__ void __launch_bounds__(kThreads) k_cumprod_apply(ScanView v, const uint32_t* totals,
                                                            int field) {
  __shared__ Fe warp_sum[kWarps];
  const FieldConsts F = kFields[field];
  const Fe one = fe_one(F);
  const int64_t row = blockIdx.y, tile = blockIdx.x;

  Fe carry = one;
  if (tile > 0) {  // the product of totals[row, 0 .. tile - 1]
    Fe acc = one;
    const uint32_t* src = totals + row * gridDim.x * taiga::kWords;
#pragma unroll 1
    for (int64_t t = threadIdx.x; t < tile; t += kThreads) {
      Fe x;
#pragma unroll
      for (int j = 0; j < taiga::kWords; j++) x.w[j] = src[t * taiga::kWords + j];
      acc = mulp(acc, x, F);
    }
    carry = block_product(acc, warp_sum, F);
  }

  // this thread's run, scanned serially in registers
  const int64_t i0 = tile * kTile + (int64_t)threadIdx.x * kPer;
  Fe x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; k++) {
    const int64_t i = i0 + k;
    x[k] = i < v.n ? load_limbs(v.a + v.at(i) * v.a_sn + row * v.a_sr) : one;
  }
#pragma unroll
  for (int k = 1; k < kPer; k++) x[k] = mulp(x[k - 1], x[k], F);
  const Fe run = x[kPer - 1];  // lanes past the row's end hold 1

  // the runs' totals scanned across the warp (inclusive), then exclusive
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Fe incl = run;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Fe up = shfl_up_fe(incl, d);
    if (lane >= d) incl = mulp(up, incl, F);
  }
  Fe excl = shfl_up_fe(incl, 1);
  if (lane == 0) excl = one;
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  Fe prefix = carry;
#pragma unroll 1
  for (int w = 0; w < warp; w++) prefix = mulp(prefix, warp_sum[w], F);
  prefix = mulp(prefix, excl, F);

#pragma unroll
  for (int k = 0; k < kPer; k++) {
    const int64_t i = i0 + k;
    if (i < v.n) store_limbs(v.out + v.at(i) * v.o_sn + row * v.o_sr, mulp(prefix, x[k], F));
  }
}

// One launch for a row of n <= kMaxCluster kThreads kMaxPer: grid (c, R) in
// clusters of (c, 1, 1), block `rank` of a row scanning [rank tile, (rank +
// 1) tile), tile = kThreads per.
__global__ void __launch_bounds__(kThreads) k_cumprod_cluster(ScanView v, int per, int field) {
  __shared__ Fe warp_tot[kWarps];  // each warp's product
  __shared__ Fe warp_pre[kWarps];  // the product of the block's earlier warps
  __shared__ Fe block_tot;         // the block's product, read by the cluster's later blocks
  __shared__ Fe carry;             // the product of the cluster's earlier blocks
  cg::cluster_group cluster = cg::this_cluster();
  const FieldConsts F = kFields[field];
  const Fe one = fe_one(F);
  const int64_t row = blockIdx.y;
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this thread's run, scanned serially in registers (1 past the row's end)
  const int64_t i0 = ((int64_t)rank * kThreads + threadIdx.x) * per;
  Fe x[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; k++) {
    const int64_t i = i0 + k;
    x[k] = k < per && i < v.n ? load_limbs(v.a + v.at(i) * v.a_sn + row * v.a_sr) : one;
  }
#pragma unroll
  for (int k = 1; k < kMaxPer; k++)
    if (k < per) x[k] = mulp(x[k - 1], x[k], F);
  Fe run = x[0];
#pragma unroll
  for (int k = 1; k < kMaxPer; k++)
    if (k < per) run = x[k];

  // the runs' totals scanned across the warp (inclusive), then exclusive
  Fe incl = run;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Fe up = shfl_up_fe(incl, d);
    if (lane >= d) incl = mulp(up, incl, F);
  }
  Fe excl = shfl_up_fe(incl, 1);
  if (lane == 0) excl = one;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  // lane w < kWarps: the product of warps 0 .. w - 1; lane kWarps: the
  // block's (two products deep)
  static_assert(kWarps == 4, "the warps' prefixes below are written for four warps");
  if (threadIdx.x <= kWarps) {
    const int w = threadIdx.x;
    Fe p = w == 0 ? one : warp_tot[0];
    if (w >= 2) {
      const Fe t01 = mulp(warp_tot[0], warp_tot[1], F);
      p = w == 2 ? t01 : mulp(t01, w == 3 ? warp_tot[2] : mulp(warp_tot[2], warp_tot[3], F), F);
    }
    if (w < kWarps)
      warp_pre[w] = p;
    else
      block_tot = p;
  }
  __syncthreads();
  const Fe pre = mulp(warp_pre[warp], excl, F);  // the block's elements before this run

  cluster.sync();  // every block's product is in its shared memory
  if (warp == 0) {  // the earlier blocks' products, a butterfly over lanes 0 .. blocks - 1
    Fe t = one;
    if (lane < rank) t = *cluster.map_shared_rank(&block_tot, lane);
#pragma unroll 1
    for (int d = 1; d < blocks; d <<= 1) t = mulp(t, shfl_xor_fe(t, d), F);
    if (lane == 0) carry = t;
  }
  cluster.sync();  // no block reads another's shared memory after this; carry is set
  const Fe prefix = mulp(carry, pre, F);
#pragma unroll
  for (int k = 0; k < kMaxPer; k++) {
    const int64_t i = i0 + k;
    if (k < per && i < v.n)
      store_limbs(v.out + v.at(i) * v.o_sn + row * v.o_sr, mulp(prefix, x[k], F));
  }
}

// K9 powers: out[r, i] = x_r^i for i < n, x_r at x + r xs words; out (R, n,
// 16) limbs or, `packed`, (R, n, 8) words. Grid (ceil(n / chunk), R), chunk
// = kThreads per; tab, in dynamic shared memory, holds small[0 .. T] and
// big[0 .. nbig - 1], T = 2^t, nbig = ceil(n / T).
__global__ void __launch_bounds__(kThreads) k_powers(const uint32_t* __restrict__ x, int64_t xs,
                                                     uint32_t* __restrict__ out, int64_t n, int t,
                                                     int64_t chunk, int packed, int field) {
  extern __shared__ Fe tab[];
  const FieldConsts F = kFields[field];
  const int T = 1 << t;
  const int nbig = (int)((n + T - 1) >> t);
  Fe* small = tab;          // x^0 .. x^T
  Fe* big = tab + T + 1;    // x^0, x^T, .. x^(T (nbig - 1))
  const int64_t row = blockIdx.y;
  if (threadIdx.x == 0) {
    small[0] = fe_one(F);
    small[1] = load_limbs(x + row * xs);
  }
  __syncthreads();
  // small[0 .. 2m] from small[0 .. m]: small[m + j] = small[m] small[j]
#pragma unroll 1
  for (int m = 1; m < T; m <<= 1) {
    for (int j = threadIdx.x + 1; j <= m; j += kThreads) small[m + j] = mulp(small[m], small[j], F);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    big[0] = small[0];
    if (nbig > 1) big[1] = small[T];
  }
  __syncthreads();
#pragma unroll 1
  for (int m = 1; m + 1 < nbig; m <<= 1) {
    for (int j = threadIdx.x + 1; j <= m && m + j < nbig; j += kThreads)
      big[m + j] = mulp(big[m], big[j], F);
    __syncthreads();
  }
  const int64_t end = (blockIdx.x + 1) * chunk < n ? (blockIdx.x + 1) * chunk : n;
  for (int64_t i = blockIdx.x * chunk + threadIdx.x; i < end; i += kThreads) {
    const Fe r = mulp(big[i >> t], small[i & (T - 1)], F);
    if (packed)
      taiga::store_packed(out + (row * n + i) * taiga::kWords, r);
    else
      store_limbs(out + (row * n + i) * taiga::kLimbs, r);
  }
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------

// num, den (B, C, n, 16) from cols (B, P, n, 16), sigma (P, n, 16), omega
// (n, 16), beta and gamma (B, 16) and delta (P, 16): chunk c takes columns
// c chunk .. min((c + 1) chunk, P) - 1. Grid (elements / kThreads, B C);
// bd, in dynamic shared memory, holds the chunk's beta delta^j.
__global__ void __launch_bounds__(kThreads) k_perm_terms(
    const uint32_t* __restrict__ cols, const uint32_t* __restrict__ sigma,
    const uint32_t* __restrict__ omega, const uint32_t* __restrict__ beta,
    const uint32_t* __restrict__ gamma, const uint32_t* __restrict__ delta,
    uint32_t* __restrict__ num, uint32_t* __restrict__ den, int64_t P, int64_t n, int64_t C,
    int64_t chunk, int field) {
  extern __shared__ Fe bd[];
  const FieldConsts F = kFields[field];
  const int64_t bc = blockIdx.y, c = bc % C, b = bc / C;
  const int64_t j0 = c * chunk, j1 = j0 + chunk < P ? j0 + chunk : P;
  const Fe be = load_limbs(beta + b * taiga::kLimbs);
  for (int64_t j = j0 + threadIdx.x; j < j1; j += kThreads)
    bd[j - j0] = taiga::fe_mul(be, load_limbs(delta + j * taiga::kLimbs), F);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe ga = load_limbs(gamma + b * taiga::kLimbs), w = load_limbs(omega + i * taiga::kLimbs);
  Fe pn, pd;
#pragma unroll 1
  for (int64_t j = j0; j < j1; j++) {
    const Fe x = load_limbs(cols + ((b * P + j) * n + i) * taiga::kLimbs);
    const Fe tn = taiga::fe_add(taiga::fe_add(x, taiga::fe_mul(bd[j - j0], w, F), F), ga, F);
    const Fe s = load_limbs(sigma + (j * n + i) * taiga::kLimbs);
    const Fe td = taiga::fe_add(taiga::fe_add(x, taiga::fe_mul(be, s, F), F), ga, F);
    pn = j == j0 ? tn : taiga::fe_mul(pn, tn, F);
    pd = j == j0 ? td : taiga::fe_mul(pd, td, F);
  }
  const int64_t o = (bc * n + i) * taiga::kLimbs;
  store_limbs(num + o, pn);
  store_limbs(den + o, pd);
}

// num, den (B, L, n, 16) from a, s, ap, sp (B, L, n, 16), beta and gamma
// (B, 16).
__global__ void __launch_bounds__(kThreads) k_lookup_terms(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ s,
    const uint32_t* __restrict__ ap, const uint32_t* __restrict__ sp,
    const uint32_t* __restrict__ beta, const uint32_t* __restrict__ gamma,
    uint32_t* __restrict__ num, uint32_t* __restrict__ den, int64_t B, int64_t per_proof,
    int field) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * per_proof) return;
  const FieldConsts F = kFields[field];
  const int64_t b = idx / per_proof, o = idx * taiga::kLimbs;
  const Fe be = load_limbs(beta + b * taiga::kLimbs), ga = load_limbs(gamma + b * taiga::kLimbs);
  store_limbs(num + o, taiga::fe_mul(taiga::fe_add(load_limbs(a + o), be, F),
                                   taiga::fe_add(load_limbs(s + o), ga, F), F));
  store_limbs(den + o, taiga::fe_mul(taiga::fe_add(load_limbs(ap + o), be, F),
                                   taiga::fe_add(load_limbs(sp + o), ga, F), F));
}

int64_t blocks_for(int64_t lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int taiga_mont_inv(const uint32_t* a, uint32_t* out, int64_t C, int field,
                              cudaStream_t stream) {
  if (C <= 0) return 0;
  k_mont_inv<<<(unsigned)blocks_for(C), kThreads, 0, stream>>>(a, out, C, field);
  return (int)cudaGetLastError();
}

// Tiles of a row of n elements in the two-pass form: totals (R x tiles x 8
// words) is scratch, used only when a row has more than one tile.
extern "C" int taiga_cumprod_tiles(int64_t n) { return (int)((n + kTile - 1) / kTile); }

// blocks > 0: one launch, a cluster of `blocks` blocks a row, `per`
// elements a thread (blocks kThreads per >= n); blocks == 0: the two
// passes over tiles of kTile (totals when a row spans several).
extern "C" int taiga_cumprod(const uint32_t* a, int64_t a_sn, int64_t a_sr, uint32_t* out,
                             int64_t o_sn, int64_t o_sr, int64_t n, int64_t R, int reverse,
                             int blocks, int per, uint32_t* totals, int field,
                             cudaStream_t stream) {
  if (n <= 0 || R <= 0) return 0;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  const ScanView v{a, out, n, a_sn, a_sr, o_sn, o_sr, reverse};
  if (blocks > 0) {
    if (blocks > kMaxCluster || per < 1 || per > kMaxPer || (int64_t)blocks * kThreads * per < n)
      return (int)cudaErrorInvalidValue;
    static bool wide = false;  // a cluster over 8 blocks needs the non-portable size
    if (!wide) {
      const cudaError_t rc = cudaFuncSetAttribute(
          k_cumprod_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (rc != cudaSuccess) return (int)rc;
      wide = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, (unsigned)R);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, k_cumprod_cluster, v, per, field);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFF || (tiles > 1 && totals == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)R);
  if (tiles > 1) {
    k_cumprod_totals<<<grid, kThreads, 0, stream>>>(v, totals, field);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  k_cumprod_apply<<<grid, kThreads, 0, stream>>>(v, tiles > 1 ? totals : nullptr, field);
  return (int)cudaGetLastError();
}

// out (R, n, 16), or (R, n, 8) words when `packed`: x_r^i for i < n, x_r at
// x + r xs words; t the tables' log2 T (T^2 >= n, t <= kMaxPowLog), per the
// elements a thread writes (a block's chunk is kThreads per).
extern "C" int taiga_powers(const uint32_t* x, int64_t xs, uint32_t* out, int64_t n, int64_t R,
                            int t, int per, int packed, int field, cudaStream_t stream) {
  if (n <= 0 || R <= 0) return 0;
  if (R > 65535 || t < 0 || t > kMaxPowLog || per < 1 || ((int64_t)1 << (2 * t)) < n)
    return (int)cudaErrorInvalidValue;
  const int64_t T = (int64_t)1 << t, nbig = (n + T - 1) >> t;
  const size_t smem = (size_t)(T + 1 + nbig) * sizeof(Fe);
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(k_powers, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int64_t chunk = (int64_t)kThreads * per, chunks = (n + chunk - 1) / chunk;
  if (chunks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  k_powers<<<dim3((unsigned)chunks, (unsigned)R), kThreads, smem, stream>>>(x, xs, out, n, t, chunk,
                                                                          packed, field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_perm_terms(const uint32_t* cols, const uint32_t* sigma,
                                const uint32_t* omega, const uint32_t* beta,
                                const uint32_t* gamma, const uint32_t* delta, uint32_t* num,
                                uint32_t* den, int64_t B, int64_t P, int64_t n, int64_t chunk,
                                int field, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || n <= 0) return 0;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  const int64_t C = (P + chunk - 1) / chunk;
  const size_t smem = (size_t)(chunk < P ? chunk : P) * sizeof(Fe);
  if (B * C > 65535 || blocks_for(n) > 0x7FFFFFFF || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_for(n), (unsigned)(B * C));
  k_perm_terms<<<grid, kThreads, smem, stream>>>(cols, sigma, omega, beta, gamma, delta, num,
                                                  den, P, n, C, chunk, field);
  return (int)cudaGetLastError();
}

extern "C" int taiga_lookup_terms(const uint32_t* a, const uint32_t* s, const uint32_t* ap,
                                  const uint32_t* sp, const uint32_t* beta,
                                  const uint32_t* gamma, uint32_t* num, uint32_t* den,
                                  int64_t B, int64_t per_proof, int field, cudaStream_t stream) {
  if (B <= 0 || per_proof <= 0) return 0;
  k_lookup_terms<<<(unsigned)blocks_for(B * per_proof), kThreads, 0, stream>>>(
      a, s, ap, sp, beta, gamma, num, den, B, per_proof, field);
  return (int)cudaGetLastError();
}
