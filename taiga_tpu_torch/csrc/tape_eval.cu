// K4: register-machine interpreter for compiled constraint tapes
// (taiga_tpu_torch/plonk/tape.py) over a domain of D lanes.
//
// Replaces taiga_tpu/ops/tape_device.py::_tape_eval_pallas. The instruction
// stream (op, dst, a, b, c) is the same for every lane, so every thread of a
// warp takes the same branch: dispatch is warp-uniform and the code rows are
// broadcast reads. One thread per lane walks the whole tape.
//
//   LOAD  dst <- table a at lane (i + LPAD + b) of the padded table
//                (tape_device.pad_tables: rotation b in (-LPAD, RPAD))
//   ADD   dst <- reg a + reg b        ADDS  dst <- reg a + scalar b
//   MUL   dst <- reg a * reg b        MULS  dst <- reg a * scalar b
//   NEG   dst <- -reg a
//
// The register file lives in device memory laid out [R][16][D] (allocated
// by the wrapper), so each register access is 16 coalesced rows. Bound on
// this card: bytes of register traffic (up to 192 B per lane per
// instruction); keeping the register file on chip is later work.

#include "field.cuh"

namespace {

constexpr int kLpad = 128;

enum Op : int32_t { OP_LOAD = 0, OP_ADD, OP_ADDS, OP_MUL, OP_MULS, OP_NEG };

__device__ __forceinline__ taiga::Fe load_scalar(const uint32_t* scalars, int32_t s) {
  taiga::Fe r;
#pragma unroll
  for (int j = 0; j < taiga::kWords; j++) {
    r.w[j] = scalars[s * taiga::kLimbs + 2 * j] | (scalars[s * taiga::kLimbs + 2 * j + 1] << 16);
  }
  return r;
}

__global__ void k_tape_eval(const int32_t* __restrict__ code, int32_t n_ins,
                            const uint32_t* __restrict__ scalars,
                            const uint32_t* __restrict__ tables, int64_t tstride,
                            uint32_t* __restrict__ regs, int64_t D, int field) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= D) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  const int64_t reg_stride = (int64_t)taiga::kLimbs * D;
  for (int32_t i = 0; i < n_ins; i++) {
    const int32_t op = code[5 * i + 0];
    const int32_t dst = code[5 * i + 1];
    const int32_t a = code[5 * i + 2];
    const int32_t b = code[5 * i + 3];
    uint32_t* out = regs + dst * reg_stride;
    if (op == OP_LOAD) {
      const uint32_t* src = tables + (int64_t)a * taiga::kLimbs * tstride;
      const int64_t col = lane + kLpad + b;
#pragma unroll
      for (int j = 0; j < taiga::kLimbs; j++) out[j * D + lane] = src[j * tstride + col];
      continue;
    }
    taiga::Fe x = taiga::load_fe(regs + a * reg_stride, D, lane);
    taiga::Fe r;
    switch (op) {
      case OP_ADD:
        r = taiga::fe_add(x, taiga::load_fe(regs + b * reg_stride, D, lane), F);
        break;
      case OP_ADDS:
        r = taiga::fe_add(x, load_scalar(scalars, b), F);
        break;
      case OP_MUL:
        r = taiga::fe_mul(x, taiga::load_fe(regs + b * reg_stride, D, lane), F);
        break;
      case OP_MULS:
        r = taiga::fe_mul(x, load_scalar(scalars, b), F);
        break;
      default: {  // OP_NEG
        taiga::Fe zero;
#pragma unroll
        for (int j = 0; j < taiga::kWords; j++) zero.w[j] = 0;
        r = taiga::fe_sub(zero, x, F);
      }
    }
    taiga::store_fe(out, D, lane, r);
  }
}

}  // namespace

extern "C" int taiga_tape_eval(const int32_t* code, int32_t n_ins, const uint32_t* scalars,
                               const uint32_t* tables, int64_t tstride, uint32_t* regs,
                               int64_t D, int field, cudaStream_t stream) {
  if (D <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (D + threads - 1) / threads;
  k_tape_eval<<<(unsigned)blocks, threads, 0, stream>>>(code, n_ins, scalars, tables, tstride,
                                                         regs, D, field);
  return (int)cudaGetLastError();
}
