// 255-bit prime-field and Pasta-curve arithmetic shared by every kernel of
// taiga_tpu_torch (K1 mont_mul, K2/K3 ec_add_proj[_sel], K4 tape_eval).
//
// Replaces the in-kernel helpers of taiga_tpu/ops/ff_kernels.py
// (_mm_cios, _madd, _msub, _mul15, _ec_add_proj_core). Memory layout is the
// reference's limb-major one: a batch of B field elements is 16 rows of B
// 16-bit limbs (stored in 32-bit words), so a warp's 32 lanes read 32
// neighbouring words of one row: every load and store coalesces.
//
// In registers an element is 8 little-endian 32-bit words. The Montgomery
// product is CIOS over 32-bit digits with 64-bit partial products. Its
// result, (a*b + m*p) / 2^256 with the unique m = -a*b/p mod 2^256, followed
// by one conditional subtract, is the value the reference's 16-bit CIOS
// computes, bit for bit, for every 256-bit input.
//
// The field constants live in constant memory, keyed by the field id that
// the Python side maps from the field's name ("fp" -> 0, "fq" -> 1); the
// host fills them once after loading the library (taiga_set_field).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace taiga {

constexpr int kWords = 8;    // 32-bit words per element
constexpr int kLimbs = 16;   // 16-bit limbs per element

struct FieldConsts {
  uint32_t p[kWords];  // modulus, little-endian words
  uint32_t n0;         // -p^-1 mod 2^32
};

__constant__ FieldConsts kFields[2];

struct Fe {
  uint32_t w[kWords];
};

// --- limb-major loads / stores ----------------------------------------------

__device__ __forceinline__ Fe load_fe(const uint32_t* base, int64_t stride, int64_t lane) {
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    uint32_t lo = base[(2 * j) * stride + lane];
    uint32_t hi = base[(2 * j + 1) * stride + lane];
    r.w[j] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fe(uint32_t* base, int64_t stride, int64_t lane, const Fe& a) {
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    base[(2 * j) * stride + lane] = a.w[j] & 0xFFFFu;
    base[(2 * j + 1) * stride + lane] = a.w[j] >> 16;
  }
}

// --- field ops ------------------------------------------------------------------

// a + b mod p (reference _madd: carry chain, then one conditional subtract
// taken when there is no borrow out of s - p or the sum carried out of 2^256).
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConsts& F) {
  Fe s, d;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    c += (uint64_t)a.w[j] + b.w[j];
    s.w[j] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t carry = (uint32_t)c;
  int64_t br = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    int64_t v = (int64_t)s.w[j] - F.p[j] + br;
    d.w[j] = (uint32_t)v;
    br = v >> 32;  // 0 or -1
  }
  bool ge = (br == 0) || (carry != 0);
  return ge ? d : s;
}

// a - b mod p (reference _msub: subtract with borrow; on a borrow add p back,
// dropping the carry out of 2^256).
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConsts& F) {
  Fe d;
  int64_t br = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    int64_t v = (int64_t)a.w[j] - b.w[j] + br;
    d.w[j] = (uint32_t)v;
    br = v >> 32;
  }
  if (br != 0) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; j++) {
      c += (uint64_t)d.w[j] + F.p[j];
      d.w[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

// Montgomery product a*b*2^-256 mod p, CIOS over 32-bit digits.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConsts& F) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; j++) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F.n0;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; j++) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
  Fe r, d;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = t[j];
  int64_t br = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    int64_t v = (int64_t)r.w[j] - F.p[j] + br;
    d.w[j] = (uint32_t)v;
    br = v >> 32;
  }
  bool ge = (br == 0) || (t[kWords] != 0);
  return ge ? d : r;
}

// 15*t as 16t - t (four doublings and a subtract): b3 = 3b = 15 for both
// Pasta curves (reference _mul15).
__device__ __forceinline__ Fe fe_mul15(const Fe& t, const FieldConsts& F) {
  Fe d = fe_add(t, t, F);
  d = fe_add(d, d, F);
  d = fe_add(d, d, F);
  d = fe_add(d, d, F);
  return fe_sub(d, t, F);
}

// Complete homogeneous-projective addition for a = 0, b3 = 15
// (Renes-Costello-Batina 2015, Algorithm 7), step for step the reference's
// _ec_add_proj_core: identity (0:1:0) and doubling need no case analysis.
__device__ __forceinline__ void ec_add_proj(Fe& x3, Fe& y3, Fe& z3,
                                            const Fe& x1, const Fe& y1, const Fe& z1,
                                            const Fe& x2, const Fe& y2, const Fe& z2,
                                            const FieldConsts& F) {
  Fe t0 = fe_mul(x1, x2, F);
  Fe t1 = fe_mul(y1, y2, F);
  Fe t2 = fe_mul(z1, z2, F);
  Fe t3 = fe_mul(fe_add(x1, y1, F), fe_add(x2, y2, F), F);
  t3 = fe_sub(t3, fe_add(t0, t1, F), F);
  Fe t4 = fe_mul(fe_add(y1, z1, F), fe_add(y2, z2, F), F);
  t4 = fe_sub(t4, fe_add(t1, t2, F), F);
  Fe xx = fe_mul(fe_add(x1, z1, F), fe_add(x2, z2, F), F);
  Fe yy = fe_sub(xx, fe_add(t0, t2, F), F);
  xx = fe_add(t0, t0, F);
  t0 = fe_add(xx, t0, F);
  t2 = fe_mul15(t2, F);
  Fe zz = fe_add(t1, t2, F);
  t1 = fe_sub(t1, t2, F);
  yy = fe_mul15(yy, F);
  x3 = fe_sub(fe_mul(t3, t1, F), fe_mul(t4, yy, F), F);
  y3 = fe_add(fe_mul(yy, t0, F), fe_mul(t1, zz, F), F);
  t0 = fe_mul(t0, t3, F);
  z3 = fe_add(fe_mul(zz, t4, F), t0, F);
}

}  // namespace taiga

// Fills one field's constants; the host calls it once per field after load.
extern "C" int taiga_set_field(int field, const uint32_t* p, uint32_t n0) {
  if (field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  taiga::FieldConsts c;
  for (int j = 0; j < taiga::kWords; j++) c.p[j] = p[j];
  c.n0 = n0;
  return (int)cudaMemcpyToSymbol(taiga::kFields, &c, sizeof(c),
                                 field * sizeof(taiga::FieldConsts));
}
