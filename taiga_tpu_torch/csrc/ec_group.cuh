// A complete projective point add computed by a group of threads together.
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

}  // namespace taiga
