// The conversion out of Montgomery form and the MSM's window digits: K16
// from_mont and K17 msm_digits.
//
// Replace no Pallas kernel: the JAX package compiles each into an XLA
// program. K16 is taiga_tpu/plonk/prover.py::_from_mont_jit (:739),
// taiga_tpu/ops/limbs.py's mont_mul by 1; run eagerly, that product is a
// 16-step CIOS over a float64 accumulator, some 260 dispatched torch ops a
// call, at every commit, the query evaluations and the multiopen. (The
// port has no device site of _to_mont_jit: it converts the instance
// column on the host, and K15 copies its outputs from its Montgomery
// inputs.) K17 is the front of
// taiga_tpu/ops/msm.py::_msm_fixed_dev (:649-673): _digits_all (:44-53)
// under vmap and the composite sort key; run eagerly, a Python loop of 32
// windows a column, about 100 ops a column.
//
// K16 (k_from_mont): one thread an element of any (..., 16) contiguous
// rows, one Montgomery product by 1 (a R^-1). The element is read and
// written as four 16-byte vectors. Bound: bytes (64 B in, 64 B out against
// one 264-multiply-add product).
//
// K17 (k_msm_digits): the c-bit window digits of C columns of N plain
// scalars (C, N, 16), c dividing 16, W = 256 / c windows, one thread a
// scalar (its 64 B read once, its W keys written at a stride of N, so a
// warp's stores coalesce). Two forms of output, both int64:
//   keyed  (W, C, N): col 2^c + digit, the general MSMs' composite key
//          (msm_multi; msm is its C = 1);
//   packed (C W N,):  ((col 2^c + digit) << idx_bits) | lane with lane =
//          col W N + w N + i, the fixed-base path's sort key: key and lane
//          in one int64, a total order equal to a stable sort of the keys.
// Bound: bytes (W 8 B written a scalar against 64 B read).

#include "field.cuh"

namespace {

using taiga::Fe;
using taiga::FieldConsts;
using taiga::kFields;
using taiga::kLimbs;

constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) k_from_mont(const uint32_t* __restrict__ a,
                                                        uint32_t* __restrict__ out, int64_t M,
                                                        int field) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const FieldConsts F = kFields[field];
  Fe one = taiga::fe_zero();
  one.w[0] = 1u;
  taiga::store_limbs(out + e * kLimbs, taiga::fe_mul(taiga::load_limbs(a + e * kLimbs), one, F));
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) k_msm_digits(const uint32_t* __restrict__ s,
                                                         int64_t* __restrict__ out, int64_t C,
                                                         int64_t N, int c, int packed,
                                                         int idx_bits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t col = blockIdx.y;
  if (i >= N) return;
  uint32_t limb[kLimbs];
  const uint4* q = reinterpret_cast<const uint4*>(s + (col * N + i) * kLimbs);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint4 v = q[k];
    limb[4 * k] = v.x;
    limb[4 * k + 1] = v.y;
    limb[4 * k + 2] = v.z;
    limb[4 * k + 3] = v.w;
  }
  const int per_limb = 16 / c, W = 256 / c;
  const uint32_t mask = (1u << c) - 1u;
  const int64_t base = col << c;
#pragma unroll 1
  for (int w = 0; w < W; w++) {
    // limbs are below 2^16; the indexing stays in registers when unrolled
    // by the compiler, else reads the thread's local copy
    const int64_t key = base | ((limb[w / per_limb] >> (c * (w % per_limb))) & mask);
    if (packed) {
      const int64_t lane = (col * W + w) * N + i;
      out[lane] = (key << idx_bits) | lane;
    } else {
      out[((int64_t)w * C + col) * N + i] = key;
    }
  }
}

int64_t blocks_for(int64_t lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

// out (M, 16) = a (M, 16) R^-1, both contiguous, 16-byte aligned.
extern "C" int taiga_from_mont(const uint32_t* a, uint32_t* out, int64_t M, int field,
                               cudaStream_t stream) {
  if (M <= 0) return 0;
  if (field < 0 || field > 1 || blocks_for(M) > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  k_from_mont<<<(unsigned)blocks_for(M), kThreads, 0, stream>>>(a, out, M, field);
  return (int)cudaGetLastError();
}

// The window digits of s (C, N, 16) plain limbs, contiguous and 16-byte
// aligned: out (W, C, N) keyed, or (C W N,) packed with idx_bits lane bits.
extern "C" int taiga_msm_digits(const uint32_t* s, int64_t* out, int64_t C, int64_t N, int c,
                                int packed, int idx_bits, cudaStream_t stream) {
  if (C <= 0 || N <= 0) return 0;
  if (c < 1 || c > 16 || 16 % c != 0 || C > 65535 || blocks_for(N) > 0x7FFFFFFF ||
      idx_bits < 0 || idx_bits > 62)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_for(N), (unsigned)C);
  k_msm_digits<<<grid, kThreads, 0, stream>>>(s, out, C, N, c, packed, idx_bits);
  return (int)cudaGetLastError();
}
