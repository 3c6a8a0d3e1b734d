// The Poseidon permutation (P128Pow5T3 over the Pallas base field Fp) on a
// batch of width-3 states, one thread a state.
//
// Replaces no Pallas kernel: taiga_tpu/ops/poseidon_kernel.py::permute_batch
// is an XLA program (three lax.scan segments over limb tensors), the JAX
// package's "workhorse device kernel" for witness hashing and Merkle trees.
// Same rounds, same order: 4 full rounds (the round constants added to all
// three lanes, the x^5 S-box on all three, the MDS), 56 partial rounds (the
// S-box on lane 0 only), 4 full rounds. Every value is a canonical
// Montgomery element, so the result equals the reference's limb for limb.
//
// Bound by operations: 8 * 18 + 56 * 12 = 816 Montgomery products a state
// (~215,000 32-bit multiply-adds) against 96 bytes read and 96 written.
// Each lane is one serial chain of 256-bit products on the PTX carry chains
// of field.cuh, held in registers for all 64 rounds; the 64 x 3 round
// constants and the 3 x 3 MDS (Montgomery form) live in constant memory,
// read uniformly by a warp (every lane is in the same round).
//
// States are (N, 3, 16) int32 rows of 16-bit limbs, the module boundary's
// layout: a thread reads its 48 consecutive words. The loads are not
// coalesced, which costs nothing measurable against 816 products.

#include "field.cuh"

namespace {

constexpr int kRounds = 64;
constexpr int kHalfFull = 4;
constexpr int kPartial = 56;

__constant__ taiga::Fe kRc[kRounds][3];
__constant__ taiga::Fe kMds[3][3];

__device__ __forceinline__ taiga::Fe load_row(const uint32_t* row) {
  taiga::Fe r;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) r.w[j] = row[2 * j] | (row[2 * j + 1] << 16);
  return r;
}

__device__ __forceinline__ void store_row(uint32_t* row, const taiga::Fe& a) {
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) {
    row[2 * j] = a.w[j] & 0xFFFFu;
    row[2 * j + 1] = a.w[j] >> 16;
  }
}

__device__ __forceinline__ taiga::Fe sbox(const taiga::Fe& x, const taiga::FieldConsts& F) {
  taiga::Fe x2 = taiga::fe_mul(x, x, F);
  taiga::Fe x4 = taiga::fe_mul(x2, x2, F);
  return taiga::fe_mul(x4, x, F);
}

__device__ __forceinline__ void mds(taiga::Fe (&s)[3], const taiga::FieldConsts& F) {
  taiga::Fe t[3];
#pragma unroll
  for (int i = 0; i < 3; i++) {
    taiga::Fe acc = taiga::fe_mul(kMds[i][0], s[0], F);
    acc = taiga::fe_add(acc, taiga::fe_mul(kMds[i][1], s[1], F), F);
    t[i] = taiga::fe_add(acc, taiga::fe_mul(kMds[i][2], s[2], F), F);
  }
#pragma unroll
  for (int i = 0; i < 3; i++) s[i] = t[i];
}

__device__ __forceinline__ void full_round(taiga::Fe (&s)[3], int r, const taiga::FieldConsts& F) {
#pragma unroll
  for (int i = 0; i < 3; i++) s[i] = sbox(taiga::fe_add(s[i], kRc[r][i], F), F);
  mds(s, F);
}

__global__ void k_poseidon_permute(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                   int64_t N) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const taiga::FieldConsts F = taiga::kFields[0];  // Fp
  const uint32_t* src = in + lane * 3 * taiga::kLimbs;
  taiga::Fe s[3];
#pragma unroll
  for (int i = 0; i < 3; i++) s[i] = load_row(src + i * taiga::kLimbs);
  int r = 0;
#pragma unroll 1
  for (int j = 0; j < kHalfFull; j++, r++) full_round(s, r, F);
#pragma unroll 1
  for (int j = 0; j < kPartial; j++, r++) {
    s[0] = sbox(taiga::fe_add(s[0], kRc[r][0], F), F);
    s[1] = taiga::fe_add(s[1], kRc[r][1], F);
    s[2] = taiga::fe_add(s[2], kRc[r][2], F);
    mds(s, F);
  }
#pragma unroll 1
  for (int j = 0; j < kHalfFull; j++, r++) full_round(s, r, F);
  uint32_t* dst = out + lane * 3 * taiga::kLimbs;
#pragma unroll
  for (int i = 0; i < 3; i++) store_row(dst + i * taiga::kLimbs, s[i]);
}

}  // namespace

// Round constants (64 x 3) and MDS (3 x 3) in Montgomery form, 8 words an
// element; the host calls it once after loading the library.
extern "C" int taiga_poseidon_set_consts(const uint32_t* rc, const uint32_t* mds_m) {
  cudaError_t e = cudaMemcpyToSymbol(kRc, rc, sizeof(taiga::Fe) * kRounds * 3);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(kMds, mds_m, sizeof(taiga::Fe) * 9);
}

extern "C" int taiga_poseidon_permute(const uint32_t* in, uint32_t* out, int64_t N,
                                      cudaStream_t stream) {
  if (N <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (N + threads - 1) / threads;
  k_poseidon_permute<<<(unsigned)blocks, threads, 0, stream>>>(in, out, N);
  return (int)cudaGetLastError();
}
