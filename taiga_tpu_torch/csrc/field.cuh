// 255-bit prime-field and Pasta-curve arithmetic shared by every kernel of
// taiga_tpu_torch (K1 mont_mul, K2/K3 ec_add_proj[_sel], K4 tape_eval, K5
// ec_fold_shared, K6/K7 ec_add[_select]; csrc/ec_group.cuh builds the
// thread-group point add on it), and the element-major row loads and
// stores of K8-K17 (grand_product.cu, ntt.cu, poly.cu, lookup_sort.cu,
// convert.cu).
//
// The Montgomery product comes in two forms with the same limbs: fe_mul,
// generic CIOS on carry chains (K1-K7, K10, K14 and the rest), and
// fe_mul_pasta, the same steps with the reduction row written for the
// Pasta moduli's words in 64-bit sums (K8's last product, K9, its powers
// entry, and K11). K12 and K13 sum unreduced 512-bit products
// (mul_acc_wide) and reduce each sum once with the same rows
// (redc_pasta_sum). K8's divsteps run on their own constants (kInv).
//
// Replaces the in-kernel helpers of taiga_tpu/ops/ff_kernels.py
// (_mm_cios, _madd, _msub, _mul15, _ec_add_proj_core). Memory layout is the
// reference's limb-major one: a batch of B field elements is 16 rows of B
// 16-bit limbs (stored in 32-bit words), so a warp's 32 lanes read 32
// neighbouring words of one row: every load and store coalesces.
//
// In registers an element is 8 little-endian 32-bit words. Additions,
// subtractions and the Montgomery product run on the hardware's carry
// chains (inline PTX). The product is CIOS over 32-bit digits; its result,
// (a*b + m*p) / 2^256 with the unique m = -a*b/p mod 2^256, followed by one
// conditional subtract, is the value the reference's 16-bit CIOS computes,
// bit for bit, for every 256-bit input.
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

struct Fe {
  uint32_t w[kWords];
};

struct FieldConsts {
  Fe p;         // modulus, little-endian words
  uint32_t n0;  // -p^-1 mod 2^32
};

__constant__ FieldConsts kFields[2];

// K8's constants (csrc/grand_product.cu): the modulus in nine signed
// 30-bit limbs (limb i holds bits 30i .. 30i + 29; every limb nonnegative),
// p^-1 mod 2^30, and R^3 mod p (R = 2^256), which takes the divsteps' plain
// inverse (aR)^-1 to a^-1 R in one Montgomery product.
constexpr int kLimbs30 = 9;

struct InvConsts {
  int32_t p30[kLimbs30];
  uint32_t pinv30;
  Fe r3;
};

__constant__ InvConsts kInv[2];

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

// --- element-major rows ----------------------------------------------------------
//
// The module-boundary layout of ops/limbs.py: an element's 16 limbs in 16
// neighbouring 32-bit words, read and written as four 16-byte vectors (the
// pointer 16-byte aligned); packed, its 8 words as two.

__device__ __forceinline__ Fe load_limbs(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint4 v = q[k];
    r.w[2 * k] = v.x | (v.y << 16);
    r.w[2 * k + 1] = v.z | (v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store_limbs(uint32_t* p, const Fe& a) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < 4; k++)
    q[k] = make_uint4(a.w[2 * k] & 0xFFFFu, a.w[2 * k] >> 16, a.w[2 * k + 1] & 0xFFFFu,
                      a.w[2 * k + 1] >> 16);
}

__device__ __forceinline__ Fe load_packed(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = q[0], b = q[1];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store_packed(uint32_t* p, const Fe& a) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  q[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = 0;
  return r;
}

// A warp's shuffles of a whole element (every lane takes part).
__device__ __forceinline__ Fe shfl_up_fe(const Fe& a, int d) {
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = __shfl_up_sync(0xFFFFFFFFu, a.w[j], d);
  return r;
}

__device__ __forceinline__ Fe shfl_xor_fe(const Fe& a, int d) {
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = __shfl_xor_sync(0xFFFFFFFFu, a.w[j], d);
  return r;
}

// --- field ops ------------------------------------------------------------------
//
// Every carry chain is ONE inline-PTX statement (add.cc / addc.cc, sub.cc /
// subc.cc, mad.lo.cc / madc.hi.cc): the carry flag never has to live across
// statements, and each step of a chain is one hardware multiply-add or add
// with carry in and out, instead of a 64-bit multiply and a 64-bit add.

// s = a + b over 8 words; returns the carry out of 2^256 (0 or 1).
__device__ __forceinline__ uint32_t add8(Fe& s, const Fe& a, const Fe& b) {
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, %25, %25;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]), "=r"(s.w[4]), "=r"(s.w[5]),
        "=r"(s.w[6]), "=r"(s.w[7]),
        "=r"(c)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
        "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(0u));
  return c;
}

// s = a - b over 8 words; returns the borrow out as a mask (0 or 0xFFFFFFFF).
__device__ __forceinline__ uint32_t sub8(Fe& s, const Fe& a, const Fe& b) {
  uint32_t br;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]), "=r"(s.w[4]), "=r"(s.w[5]),
        "=r"(s.w[6]), "=r"(s.w[7]),
        "=r"(br)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
        "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(0u));
  return br;
}

// t[0..9] += a * bi: the low halves of the 8 word products in one carry
// chain, the high halves (one word up) in a second; t[9] takes the carries.
__device__ __forceinline__ void mac_row(uint32_t (&t)[kWords + 2], const Fe& a, uint32_t bi) {
  asm(
      "mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
        "r"(a.w[6]), "r"(a.w[7]), "r"(bi));
}

// The value (hi : s) reduced once: s - p when (hi : s) >= p, else s (the
// reference's single conditional subtract; hi is a carry or overflow word).
__device__ __forceinline__ Fe reduce_once(const Fe& s, uint32_t hi, const FieldConsts& F) {
  Fe d;
  uint32_t br = sub8(d, s, F.p);
  bool ge = (hi != 0) || (br == 0);
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = ge ? d.w[j] : s.w[j];
  return r;
}

// a + b mod p (reference _madd: carry chain, then one conditional subtract
// taken when there is no borrow out of s - p or the sum carried out of 2^256).
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConsts& F) {
  Fe s;
  uint32_t c = add8(s, a, b);
  return reduce_once(s, c, F);
}

// a + a mod p: fe_add(a, a), bit for bit, with the sum as a one-bit funnel
// shift (no carry chain).
__device__ __forceinline__ Fe fe_dbl(const Fe& a, const FieldConsts& F) {
  Fe s;
  s.w[0] = a.w[0] << 1;
#pragma unroll
  for (int j = 1; j < kWords; j++) s.w[j] = __funnelshift_l(a.w[j - 1], a.w[j], 1);
  return reduce_once(s, a.w[kWords - 1] >> 31, F);
}

// a - b mod p (reference _msub: subtract with borrow; on a borrow add p back,
// dropping the carry out of 2^256).
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConsts& F) {
  Fe d, q, r;
  uint32_t br = sub8(d, a, b);
#pragma unroll
  for (int j = 0; j < kWords; j++) q.w[j] = F.p.w[j] & br;
  add8(r, d, q);
  return r;
}

// Montgomery product a*b*2^-256 mod p, CIOS over 32-bit digits: per digit
// b_i, t += a*b_i, then t += m*p with m = t[0]*n0 (t[0] becomes 0) and a
// one-word shift. For every pair of 256-bit inputs t stays below 2^290
// inside a step (ten words) and below 2^258 after it; t[8] is then the
// overflow word of the final subtract. (Keeping the low and the high
// halves in two accumulators, two carry chains a row, measured no faster
// on the H100: PERF.md section 6.)
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConsts& F) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; i++) {
    mac_row(t, a, b.w[i]);
    mac_row(t, F.p, t[0] * F.n0);
#pragma unroll
    for (int j = 0; j < kWords + 1; j++) t[j] = t[j + 1];
    t[kWords + 1] = 0;
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = t[j];
  return reduce_once(r, t[kWords], F);
}

// One reduction row of the Montgomery product for the two Pasta primes
// (both fields of kFields), p = 2^254 + c with c < 2^126: t += m p with
// m = -t0 (n0 = -p^-1 = 2^32 - 1), written for p's words: p0 = 1 (m
// itself), p4 = p5 = p6 = 0, p7 = 2^30 (m << 30 and m >> 2 at words 7 and
// 8), in 64-bit sums (one 32 x 32 -> 64 multiply-add a word); then t moves
// down a word (t0 is 0). 3 wide products where CIOS's row has 9.
__device__ __forceinline__ void pasta_reduce_row(uint32_t (&t)[kWords + 2], uint32_t p1,
                                                 uint32_t p2, uint32_t p3) {
  const uint32_t m = 0u - t[0];
  uint64_t c = ((uint64_t)t[0] + m) >> 32;
  uint64_t v = (uint64_t)p1 * m + t[1] + c;
  t[1] = (uint32_t)v;
  c = v >> 32;
  v = (uint64_t)p2 * m + t[2] + c;
  t[2] = (uint32_t)v;
  c = v >> 32;
  v = (uint64_t)p3 * m + t[3] + c;
  t[3] = (uint32_t)v;
  c = v >> 32;
#pragma unroll
  for (int j = 4; j < 7; j++) {
    v = (uint64_t)t[j] + c;
    t[j] = (uint32_t)v;
    c = v >> 32;
  }
  v = (uint64_t)t[7] + (m << 30) + c;
  t[7] = (uint32_t)v;
  c = v >> 32;
  v = (uint64_t)t[8] + (m >> 2) + c;
  t[8] = (uint32_t)v;
  t[9] += (uint32_t)(v >> 32);
#pragma unroll
  for (int j = 0; j < kWords + 1; j++) t[j] = t[j + 1];
  t[kWords + 1] = 0;
}

// a b 2^-256 mod p for the two Pasta primes: fe_mul's CIOS step for step,
// so t holds the same value after every row and the result has the same
// limbs, in 64-bit sums (one 32 x 32 -> 64 multiply-add a word, where a PTX
// carry chain needs an IMAD and an IADD3 for each half), with the row
// t += m p of pasta_reduce_row. A row is 11 wide products where fe_mul's
// is 17 (tests/test_torch_ntt_kernel.py checks both moduli's words). K9
// (csrc/grand_product.cu) and K11 (csrc/ntt.cu) compute their products
// with it.
__device__ __forceinline__ Fe fe_mul_pasta(const Fe& a, const Fe& b, const FieldConsts& F) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; j++) t[j] = 0;
  const uint32_t p1 = F.p.w[1], p2 = F.p.w[2], p3 = F.p.w[3];
#pragma unroll
  for (int i = 0; i < kWords; i++) {
    const uint32_t bi = b.w[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; j++) {
      const uint64_t v = (uint64_t)a.w[j] * bi + t[j] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    const uint64_t v = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)v;
    t[kWords + 1] += (uint32_t)(v >> 32);
    pasta_reduce_row(t, p1, p2, p3);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = t[j];
  return reduce_once(r, t[kWords], F);
}

// --- lazily reduced dot products (K12, K13) --------------------------------
//
// A sum of k products of canonical elements, S < k p^2, is kept unreduced
// in 16 words (k <= 15: p < 2^254 (1 + 2^-127), so 15 p^2 < 15 2^508
// (1 + 2^-126) < 2^512) and reduced once, redc_pasta_sum.

// acc += a b, the whole 512-bit product (schoolbook rows in 64-bit sums
// into t, then one 16-word carry chain into acc; no carry out of acc while
// it holds at most 15 products of canonical elements).
__device__ __forceinline__ void mul_acc_wide(uint32_t (&acc)[2 * kWords], const Fe& a,
                                             const Fe& b) {
  uint32_t t[2 * kWords];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    const uint64_t v = (uint64_t)a.w[j] * b.w[0] + c;
    t[j] = (uint32_t)v;
    c = v >> 32;
  }
  t[kWords] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < kWords; i++) {
    c = 0;
#pragma unroll
    for (int j = 0; j < kWords; j++) {
      const uint64_t v = (uint64_t)a.w[j] * b.w[i] + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = v >> 32;
    }
    t[i + kWords] = (uint32_t)c;
  }
  asm("add.cc.u32 %0, %0, %16;\n\t"
      "addc.cc.u32 %1, %1, %17;\n\t"
      "addc.cc.u32 %2, %2, %18;\n\t"
      "addc.cc.u32 %3, %3, %19;\n\t"
      "addc.cc.u32 %4, %4, %20;\n\t"
      "addc.cc.u32 %5, %5, %21;\n\t"
      "addc.cc.u32 %6, %6, %22;\n\t"
      "addc.cc.u32 %7, %7, %23;\n\t"
      "addc.cc.u32 %8, %8, %24;\n\t"
      "addc.cc.u32 %9, %9, %25;\n\t"
      "addc.cc.u32 %10, %10, %26;\n\t"
      "addc.cc.u32 %11, %11, %27;\n\t"
      "addc.cc.u32 %12, %12, %28;\n\t"
      "addc.cc.u32 %13, %13, %29;\n\t"
      "addc.cc.u32 %14, %14, %30;\n\t"
      "addc.u32 %15, %15, %31;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15])
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]),
        "r"(t[14]), "r"(t[15]));
}

// S 2^-256 mod p, canonical, for S = acc a sum of at most 8 products of
// canonical elements, on the Pasta primes. With S = L + 2^256 H (L its low 8
// words), S 2^-256 = u + H mod p, where u = (L + M p) / 2^256 is the
// Montgomery reduction of L alone (pasta_reduce_row's 8 rows; u <= p) and
// H <= 8 (p - 1)^2 / 2^256 < 2^255 + 4c (p = 2^254 + c, c < 2^127). So
// u + H <= p + 2^255 + 4c = 3 2^254 + 5c < 2^256: their 8-word sum has no
// carry out; and it is at most 3p + 2c < 4p, so three conditional
// subtracts of p leave the canonical value.
// One reduction for 8 products, where a product reduced on its own takes 8
// rows and a modular add.
__device__ __forceinline__ Fe redc_pasta_sum(const uint32_t (&acc)[2 * kWords],
                                             const FieldConsts& F) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords; j++) t[j] = acc[j];
  t[kWords] = t[kWords + 1] = 0;
  const uint32_t p1 = F.p.w[1], p2 = F.p.w[2], p3 = F.p.w[3];
#pragma unroll
  for (int i = 0; i < kWords; i++) pasta_reduce_row(t, p1, p2, p3);
  Fe u, h, r;
#pragma unroll
  for (int j = 0; j < kWords; j++) {
    u.w[j] = t[j];
    h.w[j] = acc[kWords + j];
  }
  add8(r, u, h);
#pragma unroll
  for (int k = 0; k < 3; k++) r = reduce_once(r, 0, F);
  return r;
}

// 15*t as 16t - t (four doublings and a subtract): b3 = 3b = 15 for both
// Pasta curves (reference _mul15).
__device__ __forceinline__ Fe fe_mul15(const Fe& t, const FieldConsts& F) {
  Fe d = fe_dbl(t, F);
  d = fe_dbl(d, F);
  d = fe_dbl(d, F);
  d = fe_dbl(d, F);
  return fe_sub(d, t, F);
}

// The inlined Montgomery product as a functor: the default of the point
// formulas below; csrc/ec_group.cuh adds the called one (MulCall).
struct MulInline {
  __device__ __forceinline__ Fe operator()(const Fe& a, const Fe& b, const FieldConsts& F) const {
    return fe_mul(a, b, F);
  }
};

// Complete homogeneous-projective addition for a = 0, b3 = 15
// (Renes-Costello-Batina 2015, Algorithm 7), step for step the reference's
// _ec_add_proj_core: identity (0:1:0) and doubling need no case analysis.
// `Mul` computes every product (inlined by default).
template <class Mul = MulInline>
__device__ __forceinline__ void ec_add_proj(Fe& x3, Fe& y3, Fe& z3,
                                            const Fe& x1, const Fe& y1, const Fe& z1,
                                            const Fe& x2, const Fe& y2, const Fe& z2,
                                            const FieldConsts& F) {
  const Mul mul;
  Fe t0 = mul(x1, x2, F);
  Fe t1 = mul(y1, y2, F);
  Fe t2 = mul(z1, z2, F);
  Fe t3 = mul(fe_add(x1, y1, F), fe_add(x2, y2, F), F);
  t3 = fe_sub(t3, fe_add(t0, t1, F), F);
  Fe t4 = mul(fe_add(y1, z1, F), fe_add(y2, z2, F), F);
  t4 = fe_sub(t4, fe_add(t1, t2, F), F);
  Fe xx = mul(fe_add(x1, z1, F), fe_add(x2, z2, F), F);
  Fe yy = fe_sub(xx, fe_add(t0, t2, F), F);
  xx = fe_dbl(t0, F);
  t0 = fe_add(xx, t0, F);
  t2 = fe_mul15(t2, F);
  Fe zz = fe_add(t1, t2, F);
  t1 = fe_sub(t1, t2, F);
  yy = fe_mul15(yy, F);
  x3 = fe_sub(mul(t3, t1, F), mul(t4, yy, F), F);
  y3 = fe_add(mul(yy, t0, F), mul(t1, zz, F), F);
  t0 = mul(t0, t3, F);
  z3 = fe_add(mul(zz, t4, F), t0, F);
}

}  // namespace taiga

// Fills one field's constants (K8's from p and r3 = R^3 mod p); the host
// calls it once per field after load.
extern "C" int taiga_set_field(int field, const uint32_t* p, uint32_t n0, const uint32_t* r3) {
  if (field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  taiga::FieldConsts c;
  for (int j = 0; j < taiga::kWords; j++) c.p.w[j] = p[j];
  c.n0 = n0;
  cudaError_t rc = cudaMemcpyToSymbol(taiga::kFields, &c, sizeof(c),
                                      field * sizeof(taiga::FieldConsts));
  if (rc != cudaSuccess) return (int)rc;
  taiga::InvConsts v;
  for (int i = 0; i < taiga::kLimbs30; i++) {  // bits 30i .. 30i + 29 of p
    const int j = 30 * i / 32, s = 30 * i % 32;
    uint64_t w = p[j];
    if (j + 1 < taiga::kWords) w |= (uint64_t)p[j + 1] << 32;
    v.p30[i] = (int32_t)((w >> s) & 0x3FFFFFFFu);
  }
  uint32_t inv = 1;  // p^-1 mod 2^32 by Newton's iteration (p odd): 1, 2, 4, .. 32 bits
  for (int k = 0; k < 5; k++) inv *= 2u - p[0] * inv;
  v.pinv30 = inv & 0x3FFFFFFFu;
  for (int j = 0; j < taiga::kWords; j++) v.r3.w[j] = r3[j];
  return (int)cudaMemcpyToSymbol(taiga::kInv, &v, sizeof(v), field * sizeof(taiga::InvConsts));
}
