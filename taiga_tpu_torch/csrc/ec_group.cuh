// Point adds computed by a group of threads together: the complete
// projective add here, and the Jacobian add and doubling below.
//
// One RCB add (Renes-Costello-Batina 2015, Algorithm 7; csrc/field.cuh
// ec_add_proj, the reference's _ec_add_proj_core) is a dependent chain in
// two product stages, each of six INDEPENDENT Montgomery products:
//
//   stage A  t0 = x1 x2, t1 = y1 y2, t2 = z1 z2,
//            (x1 + y1)(x2 + y2), (y1 + z1)(y2 + z2), (x1 + z1)(x2 + z2)
//   stage B  t3 t1, t4 y3, y3 t0, t1 z3, t0 t3, z3 t4
//
// with short add/sub chains before, between and after. One thread running
// the whole add waits for twelve products one after another; here a group
// of kGroup = 8 threads of one warp runs it, rank r < 6 computing product r
// of each stage. Every rank runs the same instructions on its own operands
// (picked by selects, not branches), so the group's product stage costs one
// product's latency. The six products go through the group's shared-memory
// scratch (one 32-byte row per product, __syncwarp on the group's mask
// before and after the reads).
//
// The add/sub chains are computed redundantly by every thread of the group:
// each thread then holds every value it needs for its next operands, and a
// stage needs one exchange, not one per value. Every thread ends holding
// the sum. The field operations, their operands and their order are
// ec_add_proj's, so the sum's limbs equal K2's bit for bit.
//
// Two independent adds at once (12 products a stage, as K5 runs its add
// acc + base beside its doubling base + base) are two groups side by side
// in 16 threads of one warp: threads 0-7 pass the first add's operands,
// threads 8-15 the second's, and both run this routine in the same
// instruction stream.

#pragma once

#include "field.cuh"

namespace taiga {

constexpr int kGroup = 8;  // threads that compute one add together

// The group's exchange rows: product k of a stage as two 16-byte words.
struct GroupScratch {
  uint4 v[6][2];
};

// The lane bits of the group of warp thread `tid` (groups are aligned).
__device__ __forceinline__ unsigned group_mask(int tid) {
  return 0xFFu << (tid & (32 - kGroup));
}

__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < kWords; j++) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// v[r] for r < 6 by a tree of selects on the bits of r (v4 or v5 for r >= 6).
__device__ __forceinline__ Fe pick6(int r, const Fe& v0, const Fe& v1, const Fe& v2,
                                    const Fe& v3, const Fe& v4, const Fe& v5) {
  const bool b0 = r & 1;
  const Fe lo = fe_sel(r & 2, fe_sel(b0, v3, v2), fe_sel(b0, v1, v0));
  return fe_sel(r & 4, fe_sel(b0, v5, v4), lo);
}

__device__ __forceinline__ void put_row(GroupScratch& s, int k, const Fe& a) {
  s.v[k][0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  s.v[k][1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

__device__ __forceinline__ Fe get_row(const GroupScratch& s, int k) {
  const uint4 lo = s.v[k][0], hi = s.v[k][1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// One product stage: rank r < 6 writes its product a*b as row r, and every
// thread of the group reads all six rows back.
__device__ __forceinline__ void product_stage(Fe (&out)[6], const Fe& a, const Fe& b,
                                              const FieldConsts& F, GroupScratch& s, int rank,
                                              unsigned mask) {
  const Fe prod = fe_mul(a, b, F);
  if (rank < 6) put_row(s, rank, prod);
  __syncwarp(mask);
#pragma unroll
  for (int k = 0; k < 6; k++) out[k] = get_row(s, k);
  __syncwarp(mask);
}

// (x3 : y3 : z3) = (x1 : y1 : z1) + (x2 : y2 : z2), computed by the kGroup
// threads of `mask` (this thread's rank in the group: `rank`), each passing
// the same operands; `s` is the group's scratch. Every thread gets the sum.
__device__ __forceinline__ void ec_add_proj_group(Fe& x3, Fe& y3, Fe& z3,
                                                  const Fe& x1, const Fe& y1, const Fe& z1,
                                                  const Fe& x2, const Fe& y2, const Fe& z2,
                                                  const FieldConsts& F, GroupScratch& s,
                                                  int rank, unsigned mask) {
  // stage A operands: ranks 0-2 the coordinates, ranks 3-5 the sums
  // x + y, y + z, x + z of each point
  const bool sum = rank >= 3;
  const Fe u1 = pick6(rank, x1, y1, z1, x1, y1, x1), v1 = fe_sel(rank == 3, y1, z1);
  const Fe u2 = pick6(rank, x2, y2, z2, x2, y2, x2), v2 = fe_sel(rank == 3, y2, z2);
  Fe pa[6];
  product_stage(pa, fe_sel(sum, fe_add(u1, v1, F), u1), fe_sel(sum, fe_add(u2, v2, F), u2),
                F, s, rank, mask);

  // the chain between the stages, as in ec_add_proj
  Fe t0 = pa[0], t1 = pa[1], t2 = pa[2];
  const Fe t3 = fe_sub(pa[3], fe_add(t0, t1, F), F);
  const Fe t4 = fe_sub(pa[4], fe_add(t1, t2, F), F);
  Fe yy = fe_sub(pa[5], fe_add(t0, t2, F), F);
  t0 = fe_add(fe_dbl(t0, F), t0, F);
  t2 = fe_mul15(t2, F);
  const Fe zz = fe_add(t1, t2, F);
  t1 = fe_sub(t1, t2, F);
  yy = fe_mul15(yy, F);

  // stage B: t3 t1, t4 yy, yy t0, t1 zz, t0 t3, zz t4
  Fe pb[6];
  product_stage(pb, pick6(rank, t3, t4, yy, t1, t0, zz), pick6(rank, t1, yy, t0, zz, t3, t4),
                F, s, rank, mask);
  x3 = fe_sub(pb[0], pb[1], F);
  y3 = fe_add(pb[2], pb[3], F);
  z3 = fe_add(pb[5], pb[4], F);
}

// ---------------------------------------------------------------------------
// The Jacobian core: the complete Jacobian add, alone (K7) or with the
// doubling (a = 0) side by side in one group of kGroup threads (the
// ladder). The doubling on its own stays one thread a lane
// (csrc/ec_add_jac.cu), which is 4x faster at width.
//
// The general add (ec_add_jac in csrc/ec_add_jac.cu, the reference's
// _ec_add_core) is 16 Montgomery products in 5 dependent stages, the
// doubling dbl-2009-l 7 products in 3:
//
//   stage  the add P1 + P2                          the doubling 2Q
//   1      z1 z1, z2 z2, z1 z2                      X X, Y Y, Y Z
//   2      x1 z2z2, x2 z1z1, z2 z2z2, z1 z1z1       B B, (X+B)(X+B), E E
//   3      y1 t2, y2 t1, h h, z1z2 h                E (D - X3)
//   4      h hh, u1 hh, r r
//   5      r (v - x3), s1 hhh
//
// jac_head runs stages 1-3 of either or both: the add's products at ranks
// 0 .. nA-1, the doubling's after them (6, 7 and 5 products: a group of 8
// holds both), so a double-and-add step costs the add's 5 stages, not 5 +
// 3. jac_tail runs stages 4-5. Each rank computes one product a stage with
// operands picked by selects; the add/sub chains are computed by every
// thread, as in ec_add_proj_group.
//
// Bit-exactness: a Montgomery product is a function of its operands, and so
// are the additions and subtractions, so the same operations on the same
// operands, in any grouping into stages, give the one-thread formulas'
// limbs. The case order is ec_add_jac's: the other operand where one side
// is the identity (Z = 0), the doubling of P1 where h = r = 0, Z3 = 0 where
// h = 0 and r != 0. The doubling of P1 runs only in a group whose lane has
// h = r = 0 (a branch uniform over the group; ec_add_jac computes it on
// every lane and selects). The doubling has no case analysis: an identity
// lane keeps the formula's X3, Y3 with Z3 = 2YZ = 0.

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kWords; j++) acc |= a.w[j];
  return acc == 0;
}

// The Jacobian core's exchange rows: up to kGroup products a stage.
struct JacScratch {
  uint4 v[kGroup][2];
};

// v[r] for 0 <= r < the number of values (the last value otherwise), by a
// chain of selects.
template <class... T>
__device__ __forceinline__ Fe pick(int r, const Fe& v0, const T&... vs) {
  if constexpr (sizeof...(vs) == 0) {
    return v0;
  } else {
    return fe_sel(r == 0, v0, pick(r - 1, vs...));
  }
}

// A rank's operand: the add's where the rank is below the add's products
// (`dbl_rank` false), the doubling's after them.
template <bool kAdd, bool kDbl>
__device__ __forceinline__ Fe either(bool dbl_rank, const Fe& add, const Fe& dbl) {
  if constexpr (kAdd && kDbl) {
    return fe_sel(dbl_rank, dbl, add);
  } else if constexpr (kAdd) {
    return add;
  } else {
    return dbl;
  }
}

// The Jacobian core's Montgomery product, one copy that every product stage
// calls. Inlined at each stage (5 a ladder step, and the 3 of the doubling
// of P1), a step was 6,624 SASS instructions; where the warps of an SM ran
// different stages at once (their lanes' bits differ) they missed the
// instruction cache, and a ladder with a scalar a lane took 2x the time of
// one with a shared scalar. Called, the ladder is 2,616 instructions and
// the two take the same time (an NVIDIA H100, PERF.md section 6). The
// operands pass by value, in registers.
__device__ __noinline__ Fe fe_mul_call(const Fe a, const Fe b, const FieldConsts F) {
  return fe_mul(a, b, F);
}

// One product stage of N <= kGroup products: rank r < N writes a*b as row
// r, and every thread of the group reads the N rows back.
template <int N>
__device__ __forceinline__ void jac_stage(Fe (&out)[N], const Fe& a, const Fe& b,
                                          const FieldConsts& F, JacScratch& s, int rank,
                                          unsigned mask) {
  static_assert(N >= 1 && N <= kGroup, "a stage holds 1 .. kGroup products");
  const Fe prod = fe_mul_call(a, b, F);
  if (rank < N) {
    s.v[rank][0] = make_uint4(prod.w[0], prod.w[1], prod.w[2], prod.w[3]);
    s.v[rank][1] = make_uint4(prod.w[4], prod.w[5], prod.w[6], prod.w[7]);
  }
  __syncwarp(mask);
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint4 lo = s.v[k][0], hi = s.v[k][1];
    out[k] = Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  }
  __syncwarp(mask);
}

// The general add's values after stage 3.
struct JacAddHead {
  Fe u1, s1, h, r, hh, z3;
};

// Stages 1-3: the general add P1 + P2 up to h, r and z3 = z1 z2 h (kAdd),
// and the whole doubling 2Q (kDbl), every thread getting both.
template <bool kAdd, bool kDbl>
__device__ __forceinline__ void jac_head(JacAddHead& a, Fe& dx, Fe& dy, Fe& dz, const Fe& x1,
                                         const Fe& y1, const Fe& z1, const Fe& x2, const Fe& y2,
                                         const Fe& z2, const Fe& qx, const Fe& qy, const Fe& qz,
                                         const FieldConsts& F, JacScratch& s, int rank,
                                         unsigned mask) {
  static_assert(kAdd || kDbl, "a head runs the add, the doubling or both");
  constexpr int nA1 = kAdd ? 3 : 0, nA2 = kAdd ? 4 : 0, nA3 = kAdd ? 4 : 0;
  constexpr int nD1 = kDbl ? 3 : 0, nD2 = kDbl ? 3 : 0, nD3 = kDbl ? 1 : 0;

  // stage 1: z1 z1, z2 z2, z1 z2 | X X, Y Y, Y Z
  Fe p1[nA1 + nD1];
  jac_stage(p1, either<kAdd, kDbl>(rank >= nA1, pick(rank, z1, z2, z1), pick(rank - nA1, qx, qy, qy)),
            either<kAdd, kDbl>(rank >= nA1, pick(rank, z1, z2, z2), pick(rank - nA1, qx, qy, qz)),
            F, s, rank, mask);
  Fe z1z1 = {}, z2z2 = {}, z1z2 = {}, a_ = {}, b_ = {}, xb = {}, e_ = {};
  if constexpr (kAdd) {
    z1z1 = p1[0];
    z2z2 = p1[1];
    z1z2 = p1[2];
  }
  if constexpr (kDbl) {
    a_ = p1[nA1];
    b_ = p1[nA1 + 1];
    const Fe yz = p1[nA1 + 2];
    xb = fe_add(qx, b_, F);
    e_ = fe_add(fe_add(a_, a_, F), a_, F);  // E = 3A
    dz = fe_add(yz, yz, F);
  }

  // stage 2: x1 z2z2, x2 z1z1, z2 z2z2, z1 z1z1 | B B, (X+B)(X+B), E E
  Fe p2[nA2 + nD2];
  jac_stage(p2, either<kAdd, kDbl>(rank >= nA2, pick(rank, x1, x2, z2, z1), pick(rank - nA2, b_, xb, e_)),
            either<kAdd, kDbl>(rank >= nA2, pick(rank, z2z2, z1z1, z2z2, z1z1),
                               pick(rank - nA2, b_, xb, e_)),
            F, s, rank, mask);
  Fe t1 = {}, t2 = {}, c8 = {}, dt = {};
  if constexpr (kAdd) {
    a.u1 = p2[0];
    a.h = fe_sub(p2[1], a.u1, F);  // h = u2 - u1
    t2 = p2[2];
    t1 = p2[3];
  }
  if constexpr (kDbl) {
    const Fe c_ = p2[nA2], xb2 = p2[nA2 + 1], f_ = p2[nA2 + 2];
    Fe d_ = fe_sub(fe_sub(xb2, a_, F), c_, F);
    d_ = fe_add(d_, d_, F);  // D = 2((X+B)^2 - A - C)
    dx = fe_sub(f_, fe_add(d_, d_, F), F);
    c8 = fe_add(fe_add(c_, c_, F), fe_add(c_, c_, F), F);
    c8 = fe_add(c8, c8, F);  // 8C
    dt = fe_sub(d_, dx, F);
  }

  // stage 3: y1 t2, y2 t1, h h, z1z2 h | E (D - X3)
  Fe p3[nA3 + nD3];
  jac_stage(p3, either<kAdd, kDbl>(rank >= nA3, pick(rank, y1, y2, a.h, z1z2), e_),
            either<kAdd, kDbl>(rank >= nA3, pick(rank, t2, t1, a.h, a.h), dt), F, s, rank,
            mask);
  if constexpr (kAdd) {
    a.s1 = p3[0];
    a.r = fe_sub(p3[1], a.s1, F);  // r = s2 - s1
    a.hh = p3[2];
    a.z3 = p3[3];
  }
  if constexpr (kDbl) dy = fe_sub(p3[nA3], c8, F);
}

// Stages 4-5: the general add's x3, y3 from its head.
__device__ __forceinline__ void jac_tail(Fe& x3, Fe& y3, const JacAddHead& a,
                                         const FieldConsts& F, JacScratch& s, int rank,
                                         unsigned mask) {
  // stage 4: h hh, u1 hh, r r
  Fe p4[3];
  jac_stage(p4, pick(rank, a.h, a.u1, a.r), pick(rank, a.hh, a.hh, a.r), F, s, rank, mask);
  const Fe hhh = p4[0], v = p4[1];
  x3 = fe_sub(fe_sub(p4[2], hhh, F), fe_add(v, v, F), F);
  // stage 5: r (v - x3), s1 hhh
  Fe p5[2];
  jac_stage(p5, pick(rank, a.r, a.s1), pick(rank, fe_sub(v, x3, F), hhh), F, s, rank, mask);
  y3 = fe_sub(p5[0], p5[1], F);
}

// The add's result from its head, for two operands that are not the
// identity: the doubling of P1 where h = r = 0, else stages 4-5, with
// Z3 = 0 where h = 0 (P1 = -P2). `mask` holds the threads that run this
// together, each a thread of a group passing its own operands: one group,
// or every group of a warp (whose stages then stay in step). The tail runs
// where any of them needs it, the doubling where any `live` one has
// h = r = 0 (a lane that is not `live` takes no add: its result is not
// read), so over a single group both are branches uniform over the group.
__device__ __forceinline__ void jac_add_finish(Fe& xo, Fe& yo, Fe& zo, const JacAddHead& a,
                                               const Fe& x1, const Fe& y1, const Fe& z1,
                                               bool live, const FieldConsts& F, JacScratch& s,
                                               int rank, unsigned mask) {
  const bool h_zero = fe_is_zero(a.h);
  const bool twice = live && h_zero && fe_is_zero(a.r);
  if (__any_sync(mask, !twice)) {
    jac_tail(xo, yo, a, F, s, rank, mask);
    zo = h_zero ? Fe{} : a.z3;
  }
  if (__any_sync(mask, twice)) {
    JacAddHead unused{};
    Fe dx, dy, dz;  // dbl-2009-l of P1, 3 stages
    jac_head<false, true>(unused, dx, dy, dz, x1, y1, z1, x1, y1, z1, x1, y1, z1, F, s, rank,
                          mask);
    if (twice) {
      xo = dx;
      yo = dy;
      zo = dz;
    }
  }
}

// (xo, yo, zo) = (x1, y1, z1) + (x2, y2, z2), complete (Z = 0 is the
// identity), by the kGroup threads of `mask`, each passing the same
// operands; every thread gets the sum. 5 product stages (6 where P1 = P2:
// 3, then the doubling's 3).
__device__ __forceinline__ void ec_add_jac_group(Fe& xo, Fe& yo, Fe& zo, const Fe& x1,
                                                 const Fe& y1, const Fe& z1, const Fe& x2,
                                                 const Fe& y2, const Fe& z2,
                                                 const FieldConsts& F, JacScratch& s, int rank,
                                                 unsigned mask) {
  const bool p_inf = fe_is_zero(z1), q_inf = fe_is_zero(z2);
  if (p_inf || q_inf) {
    xo = p_inf ? x2 : x1;
    yo = p_inf ? y2 : y1;
    zo = p_inf ? z2 : z1;
    return;
  }
  JacAddHead a;
  Fe ux, uy, uz;  // no doubling in this head
  jac_head<true, false>(a, ux, uy, uz, x1, y1, z1, x2, y2, z2, x1, y1, z1, F, s, rank, mask);
  jac_add_finish(xo, yo, zo, a, x1, y1, z1, true, F, s, rank, mask);
}

}  // namespace taiga
