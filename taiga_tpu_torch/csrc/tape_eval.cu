// K4: register-machine interpreter for compiled constraint tapes
// (taiga_tpu_torch/plonk/tape.py) over a domain of D lanes.
//
// Replaces taiga_tpu/ops/tape_device.py::_tape_eval_pallas. The instruction
// stream (op, dst, a, b) is the same for every lane, so every thread of a
// warp takes the same branch: dispatch is warp-uniform, and the stream is
// read through the constant cache (a broadcast a warp). One thread per lane
// walks the whole tape.
//
//   LOAD  dst <- table a at lane (i + LPAD + b) of the padded table
//                (tape_device.pad_tables: rotation b in (-LPAD, RPAD))
//   ADD   dst <- reg a + reg b        ADDS  dst <- reg a + scalar b
//   MUL   dst <- reg a * reg b        MULS  dst <- reg a * scalar b
//   NEG   dst <- -reg a
//
// The register file lives on chip, in shared memory: register r, word w of
// the block's lane t at file[(8r + w) * kLanes + t], two 16-bit limbs a
// 32-bit word, so a warp's 32 lanes hit 32 banks and no access leaves the
// SM, as the TPU kernel keeps its file in VMEM. A device-memory file
// [R][16][D] made the interpreter a stream of register traffic (about 200
// KB a lane for the compliance tape's 117 registers) served by the L2. The
// file takes R x 32 B a lane, so occupancy follows the register count,
// which the host pass tape_device.schedule_tape keeps small (12 for the
// compliance tape); a block takes 64 lanes (32 measured slower: the
// scalars are staged once a block). The scalars sit packed beside the
// file; LOADs pack the padded (TC, 16, D + 256) table's limbs as they
// arrive, and register 0 is written once, as the (D, 16) result rows.
// Bound on this card: operations (the products' multiply-adds), which it
// reaches about a third of (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
// section 6): each lane's tape is one serial chain, and the same scheduled
// tape over a packed device-memory file, or with the next LOAD read ahead,
// or two lanes a thread, measured no faster.

#include "field.cuh"

namespace {

constexpr int kLpad = 128;
constexpr int kLanes = 64;      // lanes (threads) of a block
constexpr int kMaxCode = 3840;  // instructions the constant bank holds (60 KB)

enum Op : int32_t { OP_LOAD = 0, OP_ADD, OP_ADDS, OP_MUL, OP_MULS, OP_NEG };

__constant__ int4 kCode[kMaxCode];  // (op, dst, a, b)

// Register r of this lane: word w at f[(8r + w) * stride].
__device__ __forceinline__ taiga::Fe get(const uint32_t* f, int stride, int r) {
  taiga::Fe v;
#pragma unroll
  for (int w = 0; w < taiga::kWords; w++) v.w[w] = f[(r * taiga::kWords + w) * stride];
  return v;
}

__device__ __forceinline__ void put(uint32_t* f, int stride, int r, const taiga::Fe& v) {
#pragma unroll
  for (int w = 0; w < taiga::kWords; w++) f[(r * taiga::kWords + w) * stride] = v.w[w];
}

// One block of kLanes threads: the packed scalars, then the block's file.
__global__ void __launch_bounds__(kLanes)
k_tape_eval(int32_t n_ins, const uint32_t* __restrict__ scalars, int32_t n_scalars,
            const uint32_t* __restrict__ tables, int64_t tstride, uint32_t* __restrict__ out,
            int64_t D, int field) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x;
  uint32_t* sc = smem;  // scalar s, word w at sc[8s + w]
  for (int k = t; k < n_scalars * taiga::kWords; k += kLanes) {
    sc[k] = scalars[2 * k] | (scalars[2 * k + 1] << 16);
  }
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * kLanes + t;
  if (lane >= D) return;
  const taiga::FieldConsts F = taiga::kFields[field];
  uint32_t* f = smem + n_scalars * taiga::kWords + t;  // register r, word w at f[(8r + w) * kLanes]
  for (int32_t i = 0; i < n_ins; i++) {
    const int4 c = kCode[i];
    if (c.x == OP_LOAD) {
      const uint32_t* src = tables + (int64_t)c.z * taiga::kLimbs * tstride + lane + kLpad + c.w;
      taiga::Fe v;
#pragma unroll
      for (int w = 0; w < taiga::kWords; w++) {
        v.w[w] = src[2 * w * tstride] | (src[(2 * w + 1) * tstride] << 16);
      }
      put(f, kLanes, c.y, v);
      continue;
    }
    const taiga::Fe x = get(f, kLanes, c.z);
    taiga::Fe r;
    switch (c.x) {
      case OP_ADD:
        r = taiga::fe_add(x, get(f, kLanes, c.w), F);
        break;
      case OP_ADDS:
        r = taiga::fe_add(x, get(sc, 1, c.w), F);
        break;
      case OP_MUL:
        r = taiga::fe_mul(x, get(f, kLanes, c.w), F);
        break;
      case OP_MULS:
        r = taiga::fe_mul(x, get(sc, 1, c.w), F);
        break;
      default: {  // OP_NEG
        taiga::Fe zero;
#pragma unroll
        for (int j = 0; j < taiga::kWords; j++) zero.w[j] = 0;
        r = taiga::fe_sub(zero, x, F);
      }
    }
    put(f, kLanes, c.y, r);
  }
  const taiga::Fe r0 = get(f, kLanes, 0);
  uint4* o = reinterpret_cast<uint4*>(out + lane * taiga::kLimbs);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    o[q] = make_uint4(r0.w[2 * q] & 0xFFFFu, r0.w[2 * q] >> 16, r0.w[2 * q + 1] & 0xFFFFu,
                      r0.w[2 * q + 1] >> 16);
  }
}

}  // namespace

// The most instructions a launch takes.
extern "C" int taiga_tape_max_code() { return kMaxCode; }

// code: (n_ins, 4) int32 rows (op, dst, a, b) on the device; scalars
// (n_scalars, 16) limbs; tables (TC, 16, tstride); out (D, 16). Each block
// of kLanes threads holds its lanes' num_regs registers and the scalars in
// (num_regs * kLanes + n_scalars) * 32 B of shared memory.
extern "C" int taiga_tape_eval(const int32_t* code, int32_t n_ins, const uint32_t* scalars,
                               int32_t n_scalars, const uint32_t* tables, int64_t tstride,
                               int32_t num_regs, uint32_t* out, int64_t D, int field,
                               cudaStream_t stream) {
  if (D <= 0 || n_ins == 0) return 0;
  if (n_ins < 0 || n_ins > kMaxCode)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMemcpyToSymbolAsync(kCode, code, (size_t)n_ins * sizeof(int4), 0,
                                           cudaMemcpyDeviceToDevice, stream);
  if (rc != cudaSuccess) return (int)rc;
  const size_t smem = (size_t)taiga::kWords * 4 * ((size_t)num_regs * kLanes + n_scalars);
  rc = cudaFuncSetAttribute(k_tape_eval, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t blocks = (D + kLanes - 1) / kLanes;
  k_tape_eval<<<(unsigned)blocks, kLanes, smem, stream>>>(n_ins, scalars, n_scalars, tables,
                                                         tstride, out, D, field);
  return (int)cudaGetLastError();
}
