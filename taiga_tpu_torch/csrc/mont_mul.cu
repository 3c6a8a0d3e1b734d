// K1: lane-wise Montgomery product over limb-major (16, B) field elements.
//
// Replaces taiga_tpu/ops/ff_kernels.py::mont_mul_lm (Pallas, body _mm_cios).
// One thread per lane; each thread reads 2 x 16 coalesced words and writes
// 16. Bound on this card: bytes (192 B moved per ~128 32-bit multiply-adds,
// well below the card's operations-per-byte balance) — nothing here is
// reused, so the design keeps loads coalesced and does nothing else.

#include "field.cuh"

namespace {

__global__ void k_mont_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out, int64_t B, int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  taiga::Fe x = taiga::load_fe(a, B, lane);
  taiga::Fe y = taiga::load_fe(b, B, lane);
  taiga::store_fe(out, B, lane, taiga::fe_mul(x, y, F));
}

}  // namespace

extern "C" int taiga_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                              int64_t B, int field, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  k_mont_mul<<<(unsigned)blocks, threads, 0, stream>>>(a, b, out, B, field);
  return (int)cudaGetLastError();
}
