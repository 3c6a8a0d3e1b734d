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
// K8 mont_inv (taiga_mont_inv): a^(p-2) for each of C lanes, 0 -> 0, one
// thread a lane, the chain in registers: 254 squarings and 75 products
// (MSB first from the top bit), bound by one thread's latency of 329
// dependent products, not by bytes or operations (C is 1 to a few dozen).
//
// K9 mont_cumprod (taiga_cumprod: k_cumprod_totals, k_cumprod_apply): inclusive
// prefix products along axis 0 of an (n, R, 16) view with any element and
// row strides (the grand products pass a moved axis, ops/poly.py::powers
// an expanded one), forward or reverse (suffix products). A block takes a
// tile of kTile elements of one row, a thread a run of kPer neighbours.
// Pass 1 (only when a row spans several tiles) writes each tile's product;
// pass 2 multiplies a block's earlier tiles' products into its carry (a
// block reduction), scans each thread's run serially in registers, scans
// the runs' totals across the block (warp shuffles, then the four warps'
// totals through shared memory) and writes carry x prefix x element. About
// 30 dependent products a thread, 2 (n - 1) products in all: the card is
// bound by bytes at these widths, and the kernel by its product latency.
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

#include "field.cuh"

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
constexpr int kPer = 8;                 // K9: elements a thread scans serially
constexpr int kTile = kThreads * kPer;  // K9: elements a block

// 1 in Montgomery form, 2^256 mod p: 2^256 - p (8 words from 0 - p), less
// p until below it (p > 2^254, so at most three times).
__device__ __forceinline__ Fe fe_one(const FieldConsts& F) {
  Fe r;
  taiga::sub8(r, taiga::fe_zero(), F.p);
#pragma unroll
  for (int k = 0; k < 3; k++) r = taiga::reduce_once(r, 0, F);
  return r;
}

// The product of every thread's x over the block, on every thread (a
// butterfly in each warp, then the warps' products through shared memory).
__device__ Fe block_product(Fe x, Fe* warp_sum, const FieldConsts& F) {
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) x = taiga::fe_mul(x, shfl_xor_fe(x, d), F);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sum[warp] = x;
  __syncthreads();
  Fe r = warp_sum[0];
#pragma unroll 1
  for (int w = 1; w < kWarps; w++) r = taiga::fe_mul(r, warp_sum[w], F);
  __syncthreads();  // warp_sum may be reused
  return r;
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) k_mont_inv(const uint32_t* __restrict__ a,
                                                       uint32_t* __restrict__ out, int64_t C,
                                                       int field) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const FieldConsts F = kFields[field];
  Fe two, e;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) two.w[j] = j == 0 ? 2u : 0u;
  taiga::sub8(e, F.p, two);  // the exponent p - 2, the same on every lane
  int top = 255;
  while (top > 0 && !((e.w[top >> 5] >> (top & 31)) & 1u)) top--;
  const Fe x = load_limbs(a + lane * taiga::kLimbs);
  Fe r = x;  // the top bit's square-and-multiply from 1
#pragma unroll 1
  for (int i = top - 1; i >= 0; i--) {
    r = taiga::fe_mul(r, r, F);
    if ((e.w[i >> 5] >> (i & 31)) & 1u) r = taiga::fe_mul(r, x, F);
  }
  store_limbs(out + lane * taiga::kLimbs, r);
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
    if (i < v.n) acc = taiga::fe_mul(acc, load_limbs(v.a + v.at(i) * v.a_sn + row * v.a_sr), F);
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
      acc = taiga::fe_mul(acc, x, F);
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
  for (int k = 1; k < kPer; k++) x[k] = taiga::fe_mul(x[k - 1], x[k], F);
  const Fe run = x[kPer - 1];  // lanes past the row's end hold 1

  // the runs' totals scanned across the warp (inclusive), then exclusive
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Fe incl = run;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Fe up = shfl_up_fe(incl, d);
    if (lane >= d) incl = taiga::fe_mul(up, incl, F);
  }
  Fe excl = shfl_up_fe(incl, 1);
  if (lane == 0) excl = one;
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  Fe prefix = carry;
#pragma unroll 1
  for (int w = 0; w < warp; w++) prefix = taiga::fe_mul(prefix, warp_sum[w], F);
  prefix = taiga::fe_mul(prefix, excl, F);

#pragma unroll
  for (int k = 0; k < kPer; k++) {
    const int64_t i = i0 + k;
    if (i < v.n) store_limbs(v.out + v.at(i) * v.o_sn + row * v.o_sr, taiga::fe_mul(prefix, x[k], F));
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

// Tiles a row of n elements: totals (R x tiles x 8 words) is scratch,
// used only when a row has more than one tile.
extern "C" int taiga_cumprod_tiles(int64_t n) { return (int)((n + kTile - 1) / kTile); }

extern "C" int taiga_cumprod(const uint32_t* a, int64_t a_sn, int64_t a_sr, uint32_t* out,
                             int64_t o_sn, int64_t o_sr, int64_t n, int64_t R, int reverse,
                             uint32_t* totals, int field, cudaStream_t stream) {
  if (n <= 0 || R <= 0) return 0;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFF || (tiles > 1 && totals == nullptr)) return (int)cudaErrorInvalidValue;
  const ScanView v{a, out, n, a_sn, a_sr, o_sn, o_sr, reverse};
  const dim3 grid((unsigned)tiles, (unsigned)R);
  if (tiles > 1) {
    k_cumprod_totals<<<grid, kThreads, 0, stream>>>(v, totals, field);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  k_cumprod_apply<<<grid, kThreads, 0, stream>>>(v, tiles > 1 ? totals : nullptr, field);
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
