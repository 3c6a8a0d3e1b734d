// The Poseidon permutation (P128Pow5T3 over the Pallas base field Fp) on a
// batch of width-3 states, and the whole ConstantLength<L> sponge over a
// batch of messages, each one launch.
//
// Replaces no Pallas kernel: taiga_tpu/ops/poseidon_kernel.py::permute_batch
// and ::hash_n_batch are XLA programs (lax.scan over limb tensors), the JAX
// package's "workhorse device kernel" for witness hashing and Merkle trees.
//
// The rounds run in the sparse form of Grassi et al. ("Poseidon: A New Hash
// Function for Zero-Knowledge Proof Systems", USENIX Security 2021,
// Appendix B), with constants derived on the host in exact Fp arithmetic
// (ops/poseidon_kernel.py::sparse_params): 4 full rounds (the round
// constants on all three lanes, the x^5 S-box on all three, a dense 3 x 3
// matrix: the MDS, and for the last of them the MDS with the partial
// rounds' first linear factor folded in), 56 partial rounds (one constant
// k on lane 0; u = x0 + k; v = (a u) (u^2)^2 = a u^5; x0' = v + b1 x1 +
// b2 x2; x1' = w1 v + x1; x2' = w2 v + x2: 8 products, not 12), 4 full
// rounds. 8 x 18 + 56 x 8 = 592 Montgomery products a state, not 816.
// Every value is a canonical Montgomery element and field arithmetic is
// exact, so the result equals the reference's limb for limb.
//
// Bound by operations (592 products against 96 bytes in and out). One
// thread a state, at the main path's 4,096-16,384 states, is one warp a
// scheduler: each waits on every product's carry chain (PR 8's kernel ran
// at 21% of its bound there). Here a state runs on a quad of threads (4
// lanes of one warp), four times the warps, each product stage holding up
// to four of the state's products side by side:
//   full round: rank r < 3 runs lane r's S-box (3 stages), the three
//     lanes are exchanged by __shfl_sync, and rank r computes row r of the
//     matrix (3 stages);
//   partial round, 3 stages: (1) rank 0 u u, rank 3 a u, ranks 1-2 the
//     previous round's w1 v and w2 v; (2) rank 0 (u^2)^2, rank 1 b1 x1,
//     rank 2 b2 x2; (3) rank 0 v = (a u) u^4. Lane 0's chain is 3 products
//     a round; x0 lives on every rank (each computes v + b1 x1 + b2 x2 from
//     the shuffled values), x1 on rank 1, x2 on rank 2.
// 216 product stages a state where one thread runs 592 products. Rank 3
// mirrors rank 2 in the full rounds; its work there is discarded. The
// product is the one called copy (fe_mul_call, csrc/ec_group.cuh), so the
// ~10 product sites do not each inline 300 instructions. Measured against
// the same sparse rounds on one thread a state (blocks of 32, 64 or 128
// threads alike): 0.181 / 0.467 / 26.6 ms at 4,096 / 16,384 / 1,048,576
// states against 0.496 / 0.508 / 18.0 (PERF.md section 6). The quad wins
// the main path's widths (a sponge of 4,096 messages, Merkle levels of
// 8,192 nodes and fewer) and loses at 1,048,576, where it issues 864
// thread-products a state for 592; it is kept.
//
// The sponge (k_poseidon_sponge) starts from (0, 0, L << 64) (Montgomery:
// L 2^64 times R^2, reduced), adds each rate block of the message into
// lanes 0-1 (ranks 0-1) and permutes, in registers throughout, and writes
// lane 0. A Merkle level is the sponge with L = 2 over the nodes read as
// pairs.
//
// States are (N, 3, 16) int32 rows of 16-bit limbs, messages (N, L, 16),
// hashes (N, 16): the module boundary's layout. A thread reads its 16
// consecutive words; the loads are not coalesced, which costs nothing
// measurable against 592 products. The constants (10.4 KB) live in
// constant memory.

#include "ec_group.cuh"

namespace {

using taiga::Fe;

constexpr int kHalf = 4;
constexpr int kPartial = 56;
constexpr unsigned kWarp = 0xFFFFFFFFu;
constexpr int kThreads = 128;

__constant__ Fe kFullRc[2 * kHalf][3];  // the full rounds' constants
__constant__ Fe kMat[2][3][3];          // the MDS; the last full round before the partials'
__constant__ Fe kA;                     // MDS[0][0]
__constant__ Fe kPart[kPartial][5];     // k, b1, b2, w1 / a, w2 / a
__constant__ Fe kR2;                    // R^2 mod p

__device__ __forceinline__ Fe load_row(const uint32_t* row) {
  Fe r;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) r.w[j] = row[2 * j] | (row[2 * j + 1] << 16);
  return r;
}

__device__ __forceinline__ void store_row(uint32_t* row, const Fe& a) {
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) {
    row[2 * j] = a.w[j] & 0xFFFFu;
    row[2 * j + 1] = a.w[j] >> 16;
  }
}

__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b, const taiga::FieldConsts& F) {
  return taiga::fe_mul_call(a, b, F);
}

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b, const taiga::FieldConsts& F) {
  return taiga::fe_add(a, b, F);
}

// Lane `src` of the warp's copy of v.
__device__ __forceinline__ Fe shfl(const Fe& v, int src) {
  Fe r;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) r.w[j] = __shfl_sync(kWarp, v.w[j], src);
  return r;
}

// One full round on a quad: x is lane l's value (rank 3: l = 2, a mirror);
// `base` is the quad's first warp lane.
__device__ __forceinline__ void full_round_quad(Fe& x, int i, int l, int base,
                                                const taiga::FieldConsts& F) {
  const Fe u = add(x, kFullRc[i][l], F);
  const Fe u2 = mul(u, u, F);
  const Fe s = mul(mul(u2, u2, F), u, F);
  const Fe s0 = shfl(s, base), s1 = shfl(s, base + 1), s2 = shfl(s, base + 2);
  const int m = i == kHalf - 1;
  Fe t = mul(kMat[m][l][0], s0, F);
  t = add(t, mul(kMat[m][l][1], s1, F), F);
  x = add(t, mul(kMat[m][l][2], s2, F), F);
}

// The permutation on a quad of threads: rank q holds lane min(q, 2) in x.
__device__ __forceinline__ void permute_quad(Fe& x, int q, int base, const taiga::FieldConsts& F) {
  const int l = q < 3 ? q : 2;
#pragma unroll 1
  for (int i = 0; i < kHalf; i++) full_round_quad(x, i, l, base, F);
  Fe x0 = shfl(x, base), v = {};
  const bool wrank = q == 1 || q == 2;  // the ranks that hold x1, x2
  const int we = q == 2 ? 4 : 3;        // their w's entry
  const int be = q == 2 ? 2 : 1;        // their b's entry
#pragma unroll 1
  for (int j = 0; j < kPartial; j++) {
    const Fe u = add(x0, kPart[j][0], F);
    // stage 1: rank 0 u u, rank 3 a u, ranks 1-2 w v of the round before
    const Fe p1 = mul(taiga::fe_sel(q == 0, u, taiga::fe_sel(q == 3, kA, kPart[j > 0 ? j - 1 : 0][we])),
                      taiga::fe_sel(wrank, v, u), F);
    if (wrank && j > 0) x = add(p1, x, F);
    // stage 2: rank 0 (u^2)^2, rank 1 b1 x1, rank 2 b2 x2
    const Fe p2 = mul(taiga::fe_sel(q == 0, p1, kPart[j][be]), taiga::fe_sel(q == 0, p1, x), F);
    const Fe au = shfl(p1, base + 3);
    const Fe q1 = shfl(p2, base + 1), q2 = shfl(p2, base + 2);
    // stage 3: rank 0 v = (a u) u^4
    v = shfl(mul(au, p2, F), base);
    x0 = add(add(v, q1, F), q2, F);
  }
  const Fe p1 = mul(kPart[kPartial - 1][we], v, F);
  if (wrank) x = add(p1, x, F);
  if (q == 0) x = x0;
#pragma unroll 1
  for (int i = kHalf; i < 2 * kHalf; i++) full_round_quad(x, i, l, base, F);
}

// The quad's state and rank; a quad past the batch runs the last state
// (every lane of a warp takes part in its shuffles) and stores nothing.
struct Quad {
  int64_t st;
  int q, base;
  bool live;
};

__device__ __forceinline__ Quad quad_of(int64_t N) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t st = t >> 2;
  const int lane = threadIdx.x & 31;
  return Quad{st < N ? st : N - 1, lane & 3, lane & ~3, st < N};
}

__global__ void __launch_bounds__(kThreads)
k_poseidon_permute(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t N) {
  const Quad Q = quad_of(N);
  const taiga::FieldConsts F = taiga::kFields[0];  // Fp
  const int l = Q.q < 3 ? Q.q : 2;
  Fe x = load_row(in + (Q.st * 3 + l) * taiga::kLimbs);
  permute_quad(x, Q.q, Q.base, F);
  if (Q.live && Q.q < 3) store_row(out + (Q.st * 3 + l) * taiga::kLimbs, x);
}

__global__ void __launch_bounds__(kThreads)
k_poseidon_sponge(const uint32_t* __restrict__ msg, uint32_t* __restrict__ out, int64_t N,
                  int L) {
  const Quad Q = quad_of(N);
  const taiga::FieldConsts F = taiga::kFields[0];
  Fe x = {};
  if (Q.q >= 2) {  // the capacity element L << 64 in Montgomery form
    Fe len = {};
    len.w[2] = (uint32_t)L;
    x = taiga::fe_mul(len, kR2, F);
  }
  const uint32_t* m = msg + Q.st * L * taiga::kLimbs;
#pragma unroll 1
  for (int c = 0; c < L; c += 2) {
    const int e = c + Q.q;  // the message element this rank absorbs
    if (Q.q < 2 && e < L) x = add(x, load_row(m + e * taiga::kLimbs), F);
    permute_quad(x, Q.q, Q.base, F);
  }
  if (Q.live && Q.q == 0) store_row(out + Q.st * taiga::kLimbs, x);
}

int64_t quad_blocks(int64_t N) { return (4 * N + kThreads - 1) / kThreads; }

}  // namespace

// The sparse form's constants in Montgomery form, 8 words an element: the
// full rounds' (8 x 3), the MDS and the last full round before the partial
// rounds' matrix (3 x 3 each), a, the partial rounds' (56 x 5), R^2; the
// host calls it once after loading the library.
extern "C" int taiga_poseidon_set_consts(const uint32_t* full, const uint32_t* mds,
                                         const uint32_t* first, const uint32_t* a,
                                         const uint32_t* part, const uint32_t* r2) {
  cudaError_t e = cudaMemcpyToSymbol(kFullRc, full, sizeof(kFullRc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kMat, mds, sizeof(Fe) * 9);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kMat, first, sizeof(Fe) * 9, sizeof(Fe) * 9);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kA, a, sizeof(Fe));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kPart, part, sizeof(kPart));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kR2, r2, sizeof(Fe));
  return (int)e;
}

extern "C" int taiga_poseidon_permute(const uint32_t* in, uint32_t* out, int64_t N,
                                      cudaStream_t stream) {
  if (N <= 0) return 0;
  k_poseidon_permute<<<(unsigned)quad_blocks(N), kThreads, 0, stream>>>(in, out, N);
  return (int)cudaGetLastError();
}

// msg (N, L, 16) -> out (N, 16): the ConstantLength<L> hash of each row.
extern "C" int taiga_poseidon_sponge(const uint32_t* msg, uint32_t* out, int64_t N, int L,
                                     cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  k_poseidon_sponge<<<(unsigned)quad_blocks(N), kThreads, 0, stream>>>(msg, out, N, L);
  return (int)cudaGetLastError();
}

