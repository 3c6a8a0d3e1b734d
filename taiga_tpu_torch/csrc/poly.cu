// The polynomial programs of the query evaluations and the multiopen: K12
// eval_polys, K13 linear_combo and K14 synthetic_div.
//
// Replace no Pallas kernel: the JAX package compiles each into one XLA
// program, taiga_tpu/ops/poly.py::eval_polys_at_points (:66),
// ::mont_linear_combo (:94) and ::synthetic_div (:77). Run eagerly, each
// field product there is a 16-step CIOS over a float64 accumulator of the
// whole broadcast shape and each sum log2(n) rounds of halving adds: the
// query evaluations of one k = 13 compliance proof broadcast its 6 points
// against 90 coefficient tables, (1, 6, 90, 2^13) products, about 1 GB of
// accumulator a proof and a thousand device operations. Here each is one
// or two launches a call with nothing of that size in device memory.
//
// Layout: element-major (..., 16) rows, the 16 16-bit limbs of an element
// in 16 neighbouring 32-bit words (the module-boundary layout of
// ops/limbs.py), read and written as four 16-byte vectors through the
// strides the wrapper passes, so an expanded or moved axis is read in
// place. Every value is a canonical Montgomery element, and field products
// and sums are exact, so any order of reduction gives the reference's
// limbs bit for bit.
//
// K12 eval_polys (k_eval_polys, k_eval_reduce): v[b, q, c] = sum_i
// coeffs[b, c, i] x[b, q]^i from the powers table x^i (B, Q, n) as packed
// words, which the wrapper takes from K9's powers entry. A block is one
// warp and takes a tile of kEvalTile = 256 positions of one (b, c) row: a
// lane holds 8 coefficients (neighbouring lanes on neighbouring positions)
// and, for one point at a time, sums their unreduced 512-bit products with
// the point's powers in one 16-word accumulator (mul_acc_wide), then
// reduces the sum once (redc_pasta_sum: the Pasta reduction rows and three
// conditional subtracts), where the design before reduced every product
// with the generic CIOS and added it modularly. The warp then sums each
// point's lanes (a butterfly of modular adds) and writes its tile's
// partial sums, which a second launch adds over the tiles (a warp an
// output; one launch when a row is one tile). The blocks are small, so a
// call's last wave is a small part of it: a proof's query evaluations are
// 2,880 blocks, 1.45 waves at 15 blocks an SM (134 registers, no spill);
// an earlier variant of 158 registers took the same time there as one
// wave of 1,440 blocks of twice the positions. Bound: operations, B Q C n
// wide products of 128 32-bit multiply-adds, one reduction of 136 a sum
// of 8 of them, and each point's n - 1 powers at 264 (a CIOS product),
// against 64 B a coefficient read once and the powers' 32 B, read from L2
// by every row c.
//
// K13 linear_combo (k_linear_combo): out[b, g, i] = add[b, g, i] + sum_s
// w[b, s] stack[b, col[s], i] over group g's terms s, for G groups of
// terms in one launch: the multiopen's point groups gathered from the
// whole coefficient stack by their column list, or (G = 1, col[s] = s, no
// addend) a plain weighted sum of C columns. A block takes a tile of 32
// positions of one proof's row, one position a lane (neighbouring lanes on
// neighbouring elements), and runs the groups in turn, so a column that
// several groups take is read again from L1 or L2; within a group its
// warps share the terms (warp w takes terms w, w + W, ..), a lane sums its
// terms' unreduced 512-bit products in runs of up to 8 (mul_acc_wide) and
// reduces each run once (redc_pasta_sum: K12's lazy sum, whose bound holds
// for 8 products of canonical elements, field.cuh), and warp 0 adds the
// other warps' sums (through shared memory, double-buffered by group) and
// the addend and stores. The host picks W (ff_kernels.linear_combo_warps):
// the terms spread over up to 8 warps while the call's blocks number two
// an SM or fewer (a proof's widest group: 256 blocks of 8 warps, where the
// design before, a thread an output element and a chain of C generic
// products, ran 128 blocks of two warps), else a warp a run (a batch's sum
// of 6 groups: one warp a block). Bound: bytes, each distinct stack
// element read once, the output and addend once (operations: a wide
// product a term and a reduction a run of 8, under half the bytes' time).
// K14 synthetic_div (k_div_totals, k_div_apply): q_i = pinv^(i+1) sum_{j>i}
// a_j p^j of each row, from the powers tables p^j and pinv^j (n + 1
// entries a row, or one row for every row: a row stride of 0), which the
// wrapper takes from powers (K9). The exclusive suffix sum is K9's scan
// with the modular add in place of the product, over the row read
// backwards: a block takes a tile of kTile positions, a thread a run of
// kPer; pass 1 (only when a row spans several tiles) writes each tile's
// sum of a_j p^j; pass 2 adds the later tiles' sums into its carry, forms
// the run's exclusive sums serially in registers, scans the runs' totals
// across the block (warp shuffles, then the warps' totals through shared
// memory) and stores (carry + prefix) pinv^(i+1). It scales by the given
// pinv's powers, so it equals the plain version for any pinv, not only p^-1.
// Bound: operations, two products an element (and the powers').

#include "field.cuh"

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::kLimbs;
using taiga::kWords;
using taiga::fe_zero;
using taiga::load_limbs;
using taiga::load_packed;
using taiga::shfl_up_fe;
using taiga::shfl_xor_fe;
using taiga::store_limbs;
using taiga::store_packed;

constexpr int kThreads = 128;           // threads a block of K14 and of K12's tile sums
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                 // K14: positions a thread takes
constexpr int kTile = kThreads * kPer;  // K14: positions of a row a block takes
constexpr int kEvalThreads = 32;        // K12: one warp a block
constexpr int kEvalPer = 8;             // K12: products a lane sums before one reduction
constexpr int kEvalTile = kEvalThreads * kEvalPer;  // K12: positions a block, a tile
constexpr int kComboWarps = 8;          // K13: warps a block at most, each a share of the terms
constexpr int kComboTile = 32;          // K13: positions a block, one a lane
constexpr int kComboRun = 8;            // K13: products a lane sums before one reduction
constexpr int kMaxComboGroups = 32;     // K13: groups a launch (their offsets passed by value)
constexpr int64_t kMaxGrid = 0x7FFFFFFF;

// The sum of x over the warp, on every lane.
__device__ __forceinline__ Fe warp_sum(Fe x, const FieldConsts& F) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = taiga::fe_add(x, shfl_xor_fe(x, d), F);
  return x;
}

// The sum of every thread's x over the block, on every thread.
__device__ Fe block_sum(Fe x, Fe* warp_part, const FieldConsts& F) {
  x = warp_sum(x, F);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = x;
  __syncthreads();
  Fe r = warp_part[0];
#pragma unroll
  for (int w = 1; w < kWarps; w++) r = taiga::fe_add(r, warp_part[w], F);
  __syncthreads();  // warp_part may be reused
  return r;
}

int64_t blocks_for(int64_t lanes, int threads) { return (lanes + threads - 1) / threads; }

// ---------------------------------------------------------------------------
// K12
// ---------------------------------------------------------------------------

struct EvalArgs {
  const uint32_t* coeffs;  // element (b, c, i) at b cb + c cc + i ci words (limbs)
  const uint32_t* pw;      // x[b, q]^i at b pb + q pq + i pi words (packed)
  uint32_t* part;          // (B, C, tiles, Q) packed partial sums, when tiles > 1
  uint32_t* out;           // (B, Q, C, 16)
  int64_t C, Q, n, tiles;
  int64_t cb, cc, ci, pb, pq, pi;
};

// Grid: B C tiles one-warp blocks, (b, c) = blockIdx.x / tiles, the tile of
// kEvalTile positions its rest.
__global__ void __launch_bounds__(kEvalThreads) k_eval_polys(EvalArgs a, int field) {
  const FieldConsts F = kFields[field];
  const int64_t bc = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int64_t b = bc / a.C, c = bc % a.C;
  const uint32_t* crow = a.coeffs + b * a.cb + c * a.cc;
  const uint32_t* prow = a.pw + b * a.pb;
  const int lane = threadIdx.x;
  const int64_t i0 = tile * kEvalTile + lane;
  Fe x[kEvalPer];
#pragma unroll
  for (int k = 0; k < kEvalPer; k++) {
    const int64_t i = i0 + k * kEvalThreads;
    x[k] = i < a.n ? load_limbs(crow + i * a.ci) : fe_zero();
  }
#pragma unroll 1
  for (int64_t q = 0; q < a.Q; q++) {
    uint32_t acc[2 * kWords];
#pragma unroll
    for (int w = 0; w < 2 * kWords; w++) acc[w] = 0;
    const uint32_t* pq = prow + q * a.pq;
#pragma unroll
    for (int k = 0; k < kEvalPer; k++) {
      const int64_t i = i0 + k * kEvalThreads;
      if (i < a.n) taiga::mul_acc_wide(acc, x[k], load_packed(pq + i * a.pi));
    }
    const Fe s = warp_sum(taiga::redc_pasta_sum(acc, F), F);
    if (lane == 0) {
      if (a.tiles == 1)
        store_limbs(a.out + ((b * a.Q + q) * a.C + c) * kLimbs, s);
      else
        store_packed(a.part + ((bc * a.tiles + tile) * a.Q + q) * kWords, s);
    }
  }
}

// out[b, q, c] = the sum over the tiles of part[b, c, tile, q], one warp
// an output element: lane l adds tiles l, l + 32, .. (their loads
// independent), then the warp's butterfly.
__global__ void __launch_bounds__(kThreads) k_eval_reduce(EvalArgs a, int64_t B, int field) {
  const int64_t o = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (o >= B * a.Q * a.C) return;  // whole warps: B Q C outputs fill them in turn
  const FieldConsts F = kFields[field];
  const int lane = threadIdx.x & 31;
  const int64_t c = o % a.C, q = (o / a.C) % a.Q, b = o / (a.C * a.Q);
  const uint32_t* src = a.part + ((b * a.C + c) * a.tiles * a.Q + q) * kWords;
  Fe s = fe_zero();
#pragma unroll 1
  for (int64_t t = lane; t < a.tiles; t += 32) s = taiga::fe_add(s, load_packed(src + t * a.Q * kWords), F);
  s = warp_sum(s, F);
  if (lane == 0) store_limbs(a.out + o * kLimbs, s);
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

struct ComboArgs {
  const uint32_t* stack;  // element (b, c, i) at stack + b sb + c sc + i si words
  const int64_t* col;     // term s's column of the stack; null: column s
  const uint32_t* w;      // weight (b, s) at w + b wb + s ws
  const uint32_t* add;    // addend (b, g, i) at add + b ab + g ag + i ai; null: none
  uint32_t* out;          // (B, G, n, 16)
  int64_t sb, sc, si, wb, ws, ab, ag, ai, n, tiles;
  int G;
  int off[kMaxComboGroups + 1];  // group g's terms: off[g] .. off[g + 1] - 1
};

// Grid: B tiles blocks of W warps, (b, tile) = blockIdx.x / tiles, % tiles.
__global__ void __launch_bounds__(kComboWarps * 32, 2) k_linear_combo(ComboArgs a, int field) {
  __shared__ Fe part[2][kComboWarps - 1][kComboTile];  // warps 1 .. W - 1's sums, by group parity
  const FieldConsts F = kFields[field];
  const int64_t b = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int64_t i = tile * kComboTile + lane;
  const bool live = i < a.n;
  const uint32_t* src = a.stack + b * a.sb + (live ? i : 0) * a.si;
  const uint32_t* wrow = a.w + b * a.wb;
#pragma unroll 1
  for (int g = 0; g < a.G; g++) {
    const int s1 = a.off[g + 1];
    Fe sum = fe_zero();
#pragma unroll 1
    for (int r0 = a.off[g] + warp; r0 < s1; r0 += warps * kComboRun) {
      uint32_t acc[2 * kWords];
#pragma unroll
      for (int k = 0; k < 2 * kWords; k++) acc[k] = 0;
#pragma unroll
      for (int k = 0; k < kComboRun; k++) {
        const int s = r0 + k * warps;
        if (s < s1 && live) {
          const int64_t c = a.col ? a.col[s] : s;
          taiga::mul_acc_wide(acc, load_limbs(wrow + s * a.ws), load_limbs(src + c * a.sc));
        }
      }
      sum = taiga::fe_add(sum, taiga::redc_pasta_sum(acc, F), F);
    }
    // warp 0 reads group g's sums after the barrier while the others go on to
    // group g + 1, which writes the other buffer; group g + 2 writes this one
    // only after the next barrier, which warp 0 reaches when it is done
    if (warp > 0) part[g & 1][warp - 1][lane] = sum;
    __syncthreads();
    if (warp == 0 && live) {
      for (int w = 1; w < warps; w++) sum = taiga::fe_add(sum, part[g & 1][w - 1][lane], F);
      if (a.add) sum = taiga::fe_add(sum, load_limbs(a.add + b * a.ab + g * a.ag + i * a.ai), F);
      store_limbs(a.out + ((b * a.G + g) * a.n + i) * kLimbs, sum);
    }
  }
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

struct DivView {
  const uint32_t* a;    // a_j of row r at a + r ar + j ae words
  const uint32_t* pw;   // p^j at pw + r pr + j pe (pr = 0: one point for every row)
  const uint32_t* ipw;  // pinv^j at ipw + r ir + j ie
  uint32_t* out;        // (R, n, 16)
  int64_t n, tiles, ar, ae, pr, pe, ir, ie;

  // a_j p^j at scan position k: the scan reads the row backwards, j = n - 1 - k
  __device__ __forceinline__ Fe term(int64_t r, int64_t k, const FieldConsts& F) const {
    const int64_t j = n - 1 - k;
    return taiga::fe_mul(load_limbs(a + r * ar + j * ae), load_limbs(pw + r * pr + j * pe), F);
  }
};

// Pass 1: the sum of each tile's terms: totals[(row, tile)], packed.
__global__ void __launch_bounds__(kThreads) k_div_totals(DivView v, uint32_t* totals, int field) {
  __shared__ Fe warp_part[kWarps];
  const FieldConsts F = kFields[field];
  const int64_t row = blockIdx.x / v.tiles, tile = blockIdx.x % v.tiles;
  const int64_t k0 = tile * kTile + (int64_t)threadIdx.x * kPer;
  Fe acc = fe_zero();
#pragma unroll 1
  for (int k = 0; k < kPer; k++)
    if (k0 + k < v.n) acc = taiga::fe_add(acc, v.term(row, k0 + k, F), F);
  const Fe t = block_sum(acc, warp_part, F);
  if (threadIdx.x == 0) store_packed(totals + (row * v.tiles + tile) * kWords, t);
}

// Pass 2: each position's exclusive sum of the terms before it in scan
// order (the row's later terms), plus the earlier tiles' totals (null
// when a row is one tile), times pinv^(j+1).
__global__ void __launch_bounds__(kThreads) k_div_apply(DivView v, const uint32_t* totals,
                                                        int field) {
  __shared__ Fe warp_part[kWarps];
  const FieldConsts F = kFields[field];
  const int64_t row = blockIdx.x / v.tiles, tile = blockIdx.x % v.tiles;

  Fe carry = fe_zero();
  if (tile > 0) {  // the sum of totals[row, 0 .. tile - 1]
    Fe acc = fe_zero();
#pragma unroll 1
    for (int64_t t = threadIdx.x; t < tile; t += kThreads)
      acc = taiga::fe_add(acc, load_packed(totals + (row * v.tiles + t) * kWords), F);
    carry = block_sum(acc, warp_part, F);
  }

  // this thread's run: x[k] becomes the sum of the run's terms before k
  const int64_t k0 = tile * kTile + (int64_t)threadIdx.x * kPer;
  Fe x[kPer];
  Fe run = fe_zero();
#pragma unroll
  for (int k = 0; k < kPer; k++) {
    x[k] = run;
    if (k0 + k < v.n) run = taiga::fe_add(run, v.term(row, k0 + k, F), F);
  }

  // the runs' totals scanned across the warp (inclusive), then exclusive
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Fe incl = run;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Fe up = shfl_up_fe(incl, d);
    if (lane >= d) incl = taiga::fe_add(up, incl, F);
  }
  Fe excl = shfl_up_fe(incl, 1);
  if (lane == 0) excl = fe_zero();
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  Fe prefix = carry;
#pragma unroll 1
  for (int w = 0; w < warp; w++) prefix = taiga::fe_add(prefix, warp_part[w], F);
  prefix = taiga::fe_add(prefix, excl, F);

#pragma unroll
  for (int k = 0; k < kPer; k++) {
    const int64_t kk = k0 + k;
    if (kk < v.n) {
      const int64_t j = v.n - 1 - kk;
      const Fe s = taiga::fe_add(prefix, x[k], F);
      store_limbs(v.out + (row * v.n + j) * kLimbs,
                  taiga::fe_mul(s, load_limbs(v.ipw + row * v.ir + (j + 1) * v.ie), F));
    }
  }
}

}  // namespace

// Tiles of a row of n positions (K14): their scratch holds one entry a
// tile, used only when a row has more than one tile.
extern "C" int taiga_poly_tiles(int64_t n) { return (int)((n + kTile - 1) / kTile); }

// out (B, Q, C, 16) = sum_i coeffs[b, c, i] pw[b, q, i]; coeffs element (b,
// c, i) at coeffs + b cb + c cc + i ci words (limbs), pw's (b, q, i) at pw +
// b pb + q pq + i pi words (packed; strides multiples of 4, pointers 16-byte
// aligned); part (B, C, tiles, Q, 8) words of scratch when a row spans
// several tiles of kEvalTile positions.
extern "C" int taiga_eval_polys(const uint32_t* coeffs, int64_t cb, int64_t cc, int64_t ci,
                                const uint32_t* pw, int64_t pb, int64_t pq, int64_t pi,
                                uint32_t* part, uint32_t* out, int64_t B, int64_t C, int64_t Q,
                                int64_t n, int field, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || Q <= 0) return 0;
  if (n <= 0 || field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kEvalTile - 1) / kEvalTile;
  if (B * C * tiles > kMaxGrid || (tiles > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  const EvalArgs a{coeffs, pw, part, out, C, Q, n, tiles, cb, cc, ci, pb, pq, pi};
  k_eval_polys<<<(unsigned)(B * C * tiles), kEvalThreads, 0, stream>>>(a, field);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || tiles == 1) return (int)rc;
  k_eval_reduce<<<(unsigned)blocks_for(B * Q * C * 32, kThreads), kThreads, 0, stream>>>(a, B,
                                                                                        field);
  return (int)cudaGetLastError();
}

// out (B, G, n, 16): out[b, g] = add[b, g] + sum over s in off[g] ..
// off[g + 1] - 1 of w[b, s] stack[b, col[s]]; stack element (b, c, i) at
// stack + b sb + c sc + i si words, weight (b, s) at w + b wb + s ws, addend
// (b, g, i) at add + b ab + g ag + i ai (null: none), col null for column s;
// off holds G + 1 offsets, G <= kMaxComboGroups groups of a term or more;
// warps a block, 1 to kComboWarps.
extern "C" int taiga_linear_combo(const uint32_t* stack, int64_t sb, int64_t sc, int64_t si,
                                  const int64_t* col, const int32_t* off, int G,
                                  const uint32_t* w, int64_t wb, int64_t ws, const uint32_t* add,
                                  int64_t ab, int64_t ag, int64_t ai, uint32_t* out, int64_t B,
                                  int64_t n, int warps, int field, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return 0;
  if (G < 1 || G > kMaxComboGroups || warps < 1 || warps > kComboWarps || field < 0 ||
      field > 1)
    return (int)cudaErrorInvalidValue;
  ComboArgs a{stack, col, w, add, out, sb, sc, si, wb, ws, ab, ag, ai, n, 0, G, {}};
  for (int g = 0; g <= G; g++) {
    a.off[g] = off[g];
    if (g > 0 && off[g] <= off[g - 1]) return (int)cudaErrorInvalidValue;
  }
  a.tiles = blocks_for(n, kComboTile);
  if (B * a.tiles > kMaxGrid) return (int)cudaErrorInvalidValue;
  k_linear_combo<<<(unsigned)(B * a.tiles), warps * 32, 0, stream>>>(a, field);
  return (int)cudaGetLastError();
}

// out (R, n, 16): q_j = pinv^(j+1) sum_{i>j} a_i p^i of each row; a's (r,
// i) at a + r ar + i ae words, p^i at pw + r pr + i pe and pinv^i at ipw +
// r ir + i ie (i <= n; pr, ir 0 for a point shared by every row); totals
// (R, tiles, 8) words of scratch when tiles > 1.
extern "C" int taiga_synthetic_div(const uint32_t* a, int64_t ar, int64_t ae, const uint32_t* pw,
                                   int64_t pr, int64_t pe, const uint32_t* ipw, int64_t ir,
                                   int64_t ie, uint32_t* out, uint32_t* totals, int64_t n,
                                   int64_t R, int field, cudaStream_t stream) {
  if (n <= 0 || R <= 0) return 0;
  if (field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (R * tiles > kMaxGrid || (tiles > 1 && totals == nullptr)) return (int)cudaErrorInvalidValue;
  const DivView v{a, pw, ipw, out, n, tiles, ar, ae, pr, pe, ir, ie};
  if (tiles > 1) {
    k_div_totals<<<(unsigned)(R * tiles), kThreads, 0, stream>>>(v, totals, field);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  k_div_apply<<<(unsigned)(R * tiles), kThreads, 0, stream>>>(v, tiles > 1 ? totals : nullptr,
                                                               field);
  return (int)cudaGetLastError();
}
