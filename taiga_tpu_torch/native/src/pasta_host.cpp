// Native host crypto engine: 4x64-limb Montgomery arithmetic over the Pasta
// fields and a batched Poseidon permutation (t = 3, P128Pow5T3 shape).
//
// This is the TPU build's counterpart of the reference's native (Rust) host
// crypto (pasta_curves field ops + halo2 poseidon primitives — see SURVEY.md
// §2.4): the JAX/Pallas device kernels own the prover's bulk math, and this
// library owns the host-side scalar crypto (resource commitments, nullifier
// derivation, Merkle folds, encryption sponge) where Python bigints are
// orders of magnitude too slow.
//
// Field elements cross the FFI boundary as 4 little-endian uint64 limbs in
// PLAIN (non-Montgomery) form. All constants (modulus, MDS, round constants)
// are supplied at init by Python — the single source of truth stays in
// taiga_tpu.crypto (Grain-derived), and this engine is differentially tested
// against it (tests/test_native.py).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libpasta_host.so pasta_host.cpp

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using u64 = uint64_t;
using u128 = unsigned __int128;

struct Field {
    u64 mod[4];    // modulus, little-endian limbs
    u64 r2[4];     // R^2 mod p (R = 2^256)
    u64 n0inv;     // -p^{-1} mod 2^64
    bool ready = false;
};

struct PoseidonParams {
    u64 mds[3][3][4];      // Montgomery form
    u64 rc[64][3][4];      // Montgomery form
    int full_rounds = 8;
    int partial_rounds = 56;
    bool ready = false;
};

static Field g_fields[2];          // 0 = Fp (Pallas base), 1 = Fq
static PoseidonParams g_poseidon[2];

// --- core limb ops ---------------------------------------------------------

static inline int add4(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a[i] + b[i];
        out[i] = (u64)c;
        c >>= 64;
    }
    return (int)c;
}

static inline int sub4(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    return (int)borrow;
}

static inline bool ge4(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;
}

static inline void mont_mul(u64 out[4], const u64 a[4], const u64 b[4],
                            const Field& f) {
    // CIOS Montgomery multiplication, 4x64 limbs.
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            carry += (u128)t[j] + (u128)a[i] * b[j];
            t[j] = (u64)carry;
            carry >>= 64;
        }
        carry += t[4];
        t[4] = (u64)carry;
        t[5] = (u64)(carry >> 64);

        u64 m = t[0] * f.n0inv;
        carry = (u128)t[0] + (u128)m * f.mod[0];
        carry >>= 64;
        for (int j = 1; j < 4; j++) {
            carry += (u128)t[j] + (u128)m * f.mod[j];
            t[j - 1] = (u64)carry;
            carry >>= 64;
        }
        carry += t[4];
        t[3] = (u64)carry;
        t[4] = t[5] + (u64)(carry >> 64);
        t[5] = 0;
    }
    u64 r[4] = {t[0], t[1], t[2], t[3]};
    if (t[4] || ge4(r, f.mod)) sub4(out, r, f.mod);
    else std::memcpy(out, r, 32);
}

static inline void mod_add(u64 out[4], const u64 a[4], const u64 b[4],
                           const Field& f) {
    u64 s[4];
    int c = add4(s, a, b);
    if (c || ge4(s, f.mod)) sub4(out, s, f.mod);
    else std::memcpy(out, s, 32);
}

static inline void mod_sub(u64 out[4], const u64 a[4], const u64 b[4],
                           const Field& f) {
    u64 s[4];
    if (sub4(s, a, b)) add4(out, s, f.mod);
    else std::memcpy(out, s, 32);
}

static void to_mont(u64 out[4], const u64 a[4], const Field& f) {
    mont_mul(out, a, f.r2, f);
}

static void from_mont(u64 out[4], const u64 a[4], const Field& f) {
    u64 one[4] = {1, 0, 0, 0};
    mont_mul(out, a, one, f);
}

// --- elliptic curve (short Weierstrass a = 0; Pallas/Vesta) ----------------
// Jacobian coordinates in Montgomery form; Z = 0 encodes the identity.

struct JPoint {
    u64 X[4], Y[4], Z[4];
};

static inline bool is_zero4(const u64 a[4]) {
    return !(a[0] | a[1] | a[2] | a[3]);
}

static inline void mont_sqr(u64 out[4], const u64 a[4], const Field& f) {
    mont_mul(out, a, a, f);
}

static void mont_pow(u64 out[4], const u64 base[4], const u64 e[4],
                     const Field& f) {
    u64 acc[4];
    u64 one[4] = {1, 0, 0, 0};
    to_mont(acc, one, f);
    for (int i = 255; i >= 0; i--) {
        mont_sqr(acc, acc, f);
        if ((e[i / 64] >> (i % 64)) & 1) mont_mul(acc, acc, base, f);
    }
    std::memcpy(out, acc, 32);
}

static void mont_inv(u64 out[4], const u64 a[4], const Field& f) {
    u64 e[4];
    std::memcpy(e, f.mod, 32);
    e[0] -= 2;  // p - 2 (p odd: no borrow)
    mont_pow(out, a, e, f);
}

static void jset_identity(JPoint& r, const Field& f) {
    u64 one[4] = {1, 0, 0, 0};
    to_mont(r.X, one, f);
    to_mont(r.Y, one, f);
    std::memset(r.Z, 0, 32);
}

static void jdouble(JPoint& r, const JPoint& pin, const Field& f) {
    JPoint p = pin;  // alias-safe
    if (is_zero4(p.Z)) { r = p; return; }
    u64 A[4], B[4], C[4], D[4], E[4], F[4], t[4], t2[4];
    mont_sqr(A, p.X, f);
    mont_sqr(B, p.Y, f);
    mont_sqr(C, B, f);
    mod_add(t, p.X, B, f);
    mont_sqr(t, t, f);
    mod_sub(t, t, A, f);
    mod_sub(t, t, C, f);
    mod_add(D, t, t, f);
    mod_add(E, A, A, f);
    mod_add(E, E, A, f);
    mont_sqr(F, E, f);
    mod_add(t, D, D, f);
    mod_sub(r.X, F, t, f);
    mod_sub(t, D, r.X, f);
    mont_mul(t, E, t, f);
    mod_add(t2, C, C, f);
    mod_add(t2, t2, t2, f);
    mod_add(t2, t2, t2, f);
    mod_sub(r.Y, t, t2, f);
    mont_mul(t, p.Y, p.Z, f);
    mod_add(r.Z, t, t, f);
}

static void jadd(JPoint& r, const JPoint& pin, const JPoint& qin,
                 const Field& f) {
    JPoint p = pin, q = qin;  // alias-safe
    if (is_zero4(p.Z)) { r = q; return; }
    if (is_zero4(q.Z)) { r = p; return; }
    u64 Z1Z1[4], Z2Z2[4], U1[4], U2[4], S1[4], S2[4], H[4], R_[4], t[4], t2[4];
    mont_sqr(Z1Z1, p.Z, f);
    mont_sqr(Z2Z2, q.Z, f);
    mont_mul(U1, p.X, Z2Z2, f);
    mont_mul(U2, q.X, Z1Z1, f);
    mont_mul(t, q.Z, Z2Z2, f);
    mont_mul(S1, p.Y, t, f);
    mont_mul(t, p.Z, Z1Z1, f);
    mont_mul(S2, q.Y, t, f);
    mod_sub(H, U2, U1, f);
    mod_sub(R_, S2, S1, f);
    if (is_zero4(H)) {
        if (is_zero4(R_)) { jdouble(r, p, f); return; }
        jset_identity(r, f);
        return;
    }
    u64 HH[4], HHH[4], V[4];
    mont_sqr(HH, H, f);
    mont_mul(HHH, H, HH, f);
    mont_mul(V, U1, HH, f);
    mont_sqr(t, R_, f);
    mod_sub(t, t, HHH, f);
    mod_sub(t, t, V, f);
    mod_sub(r.X, t, V, f);
    mod_sub(t, V, r.X, f);
    mont_mul(t, R_, t, f);
    mont_mul(t2, S1, HHH, f);
    mod_sub(r.Y, t, t2, f);
    mont_mul(t, p.Z, q.Z, f);
    mont_mul(r.Z, t, H, f);
}

// Affine plain-form point layout across the FFI: 9 u64 = x(4) | y(4) | inf(1).
static void jfrom_affine(JPoint& p, const u64* in, const Field& f) {
    if (in[8]) { jset_identity(p, f); return; }
    to_mont(p.X, in, f);
    to_mont(p.Y, in + 4, f);
    u64 one[4] = {1, 0, 0, 0};
    to_mont(p.Z, one, f);
}

static void jto_affine(u64* out, const JPoint& p, const Field& f) {
    if (is_zero4(p.Z)) {
        std::memset(out, 0, 64);
        out[8] = 1;
        return;
    }
    u64 zi[4], zi2[4], zi3[4], t[4];
    mont_inv(zi, p.Z, f);
    mont_sqr(zi2, zi, f);
    mont_mul(zi3, zi2, zi, f);
    mont_mul(t, p.X, zi2, f);
    from_mont(out, t, f);
    mont_mul(t, p.Y, zi3, f);
    from_mont(out + 4, t, f);
    out[8] = 0;
}

// --- exported API ----------------------------------------------------------

extern "C" {

// Initialize a field: modulus as 4 LE u64 limbs. R2/n0inv derived here.
void taiga_field_init(int field_id, const u64* modulus) {
    Field& f = g_fields[field_id];
    std::memcpy(f.mod, modulus, 32);
    // n0inv = -p^{-1} mod 2^64 (Newton iteration)
    u64 p0 = f.mod[0];
    u64 inv = 1;
    for (int i = 0; i < 6; i++) inv *= 2 - p0 * inv;
    f.n0inv = (u64)(0 - inv);
    // R2 = 2^512 mod p by 512 modular doublings of 1
    u64 r[4] = {1, 0, 0, 0};
    for (int i = 0; i < 512; i++) mod_add(r, r, r, f);
    std::memcpy(f.r2, r, 32);
    f.ready = true;
}

void taiga_mont_mul_batch(int field_id, u64* out, const u64* a, const u64* b,
                          long n) {
    const Field& f = g_fields[field_id];
    for (long i = 0; i < n; i++) {
        u64 am[4], bm[4], cm[4];
        to_mont(am, a + 4 * i, f);
        to_mont(bm, b + 4 * i, f);
        mont_mul(cm, am, bm, f);
        from_mont(out + 4 * i, cm, f);
    }
}

void taiga_mod_add_batch(int field_id, u64* out, const u64* a, const u64* b,
                         long n) {
    const Field& f = g_fields[field_id];
    for (long i = 0; i < n; i++)
        mod_add(out + 4 * i, a + 4 * i, b + 4 * i, f);
}

// Poseidon: MDS (9 elements) + round constants (n_rounds*3) in PLAIN form.
void taiga_poseidon_init(int field_id, const u64* mds, const u64* rc,
                         int full_rounds, int partial_rounds) {
    const Field& f = g_fields[field_id];
    PoseidonParams& p = g_poseidon[field_id];
    p.full_rounds = full_rounds;
    p.partial_rounds = partial_rounds;
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            to_mont(p.mds[i][j], mds + 4 * (3 * i + j), f);
    int total = full_rounds + partial_rounds;
    for (int r = 0; r < total; r++)
        for (int i = 0; i < 3; i++)
            to_mont(p.rc[r][i], rc + 4 * (3 * r + i), f);
    p.ready = true;
}

static inline void sbox5(u64 x[4], const Field& f) {
    u64 x2[4], x4[4];
    mont_mul(x2, x, x, f);
    mont_mul(x4, x2, x2, f);
    mont_mul(x, x4, x, f);
}

// In-place batched Poseidon permutation over states (n, 3, 4) plain u64.
void taiga_poseidon_permute_batch(int field_id, u64* states, long n) {
    const Field& f = g_fields[field_id];
    const PoseidonParams& p = g_poseidon[field_id];
    int half = p.full_rounds / 2;
    int total = p.full_rounds + p.partial_rounds;
    for (long s = 0; s < n; s++) {
        u64 st[3][4];
        for (int i = 0; i < 3; i++) to_mont(st[i], states + 12 * s + 4 * i, f);
        for (int r = 0; r < total; r++) {
            bool is_full = (r < half) || (r >= half + p.partial_rounds);
            for (int i = 0; i < 3; i++) mod_add(st[i], st[i], p.rc[r][i], f);
            if (is_full) {
                for (int i = 0; i < 3; i++) sbox5(st[i], f);
            } else {
                sbox5(st[0], f);
            }
            u64 nxt[3][4];
            for (int i = 0; i < 3; i++) {
                u64 acc[4] = {0, 0, 0, 0};
                for (int j = 0; j < 3; j++) {
                    u64 t[4];
                    mont_mul(t, p.mds[i][j], st[j], f);
                    mod_add(acc, acc, t, f);
                }
                std::memcpy(nxt[i], acc, 32);
            }
            std::memcpy(st, nxt, sizeof(st));
        }
        for (int i = 0; i < 3; i++) from_mont(states + 12 * s + 4 * i, st[i], f);
    }
}

// Poseidon Merkle fold: leaf + path of (sibling, is_left) -> root.
// ConstantLength<2> hash per level: state = (l, r, capacity), capacity
// init = 2 << 64 (matches crypto/poseidon.py ConstantLength domain).
void taiga_poseidon_hash2_chain(int field_id, u64* leaf_out,
                                const u64* siblings, const uint8_t* is_left,
                                int depth) {
    const Field& f = g_fields[field_id];
    u64 node[4];
    std::memcpy(node, leaf_out, 32);
    for (int d = 0; d < depth; d++) {
        u64 state[12];
        const u64* sib = siblings + 4 * d;
        u64 cap[4] = {0, 2, 0, 0};  // 2 * 2^64
        if (is_left[d]) {
            std::memcpy(state, sib, 32);
            std::memcpy(state + 4, node, 32);
        } else {
            std::memcpy(state, node, 32);
            std::memcpy(state + 4, sib, 32);
        }
        std::memcpy(state + 8, cap, 32);
        taiga_poseidon_permute_batch(field_id, state, 1);
        std::memcpy(node, state, 32);
    }
    std::memcpy(leaf_out, node, 32);
}

// EC ops over affine plain-form points (9 u64: x | y | inf). field_id is the
// COORDINATE field (Pallas: Fp = 0, Vesta: Fq = 1); curve is y^2 = x^3 + 5.

void taiga_ec_add(int field_id, u64* out, const u64* a, const u64* b) {
    const Field& f = g_fields[field_id];
    JPoint P, Q, R;
    jfrom_affine(P, a, f);
    jfrom_affine(Q, b, f);
    jadd(R, P, Q, f);
    jto_affine(out, R, f);
}

// out = [scalar] p, double-and-add over the fixed 256-bit window.
void taiga_ec_scalar_mul(int field_id, u64* out, const u64* p,
                         const u64* scalar) {
    const Field& f = g_fields[field_id];
    JPoint P, R;
    jfrom_affine(P, p, f);
    jset_identity(R, f);
    for (int i = 255; i >= 0; i--) {
        jdouble(R, R, f);
        if ((scalar[i / 64] >> (i % 64)) & 1) jadd(R, R, P, f);
    }
    jto_affine(out, R, f);
}

}  // extern "C" (host crypto block; MSM/NTT/vector block reopens below)

// --- Pippenger MSM ----------------------------------------------------------
// Window/bucket method, threaded over windows. Points arrive as plain-form
// affine (9 u64 each); converted once to Montgomery affine, then each window
// sweeps all points with Jacobian+affine mixed adds into its buckets and
// reduces buckets by running suffix sums.

struct APoint {
    u64 X[4], Y[4];
    bool inf;
};

// Mixed add: r (Jacobian) += q (affine, Montgomery). a = 0 curve.
static void jadd_mixed(JPoint& r, const APoint& q, const Field& f) {
    if (q.inf) return;
    if (is_zero4(r.Z)) {
        std::memcpy(r.X, q.X, 32);
        std::memcpy(r.Y, q.Y, 32);
        u64 one[4] = {1, 0, 0, 0};
        to_mont(r.Z, one, f);
        return;
    }
    u64 Z1Z1[4], U2[4], S2[4], H[4], HH[4], I[4], J[4], rr[4], V[4], t[4], t2[4];
    mont_sqr(Z1Z1, r.Z, f);
    mont_mul(U2, q.X, Z1Z1, f);
    mont_mul(t, r.Z, Z1Z1, f);
    mont_mul(S2, q.Y, t, f);
    mod_sub(H, U2, r.X, f);
    mod_sub(rr, S2, r.Y, f);
    if (is_zero4(H)) {
        if (is_zero4(rr)) { jdouble(r, r, f); return; }
        jset_identity(r, f);
        return;
    }
    mont_sqr(HH, H, f);
    mod_add(I, HH, HH, f);
    mod_add(I, I, I, f);          // I = 4*HH
    mont_mul(J, H, I, f);         // J = H*I
    mod_add(rr, rr, rr, f);       // r = 2*(S2 - Y1)
    mont_mul(V, r.X, I, f);       // V = X1*I
    mont_sqr(t, rr, f);           // r^2
    mod_sub(t, t, J, f);
    mod_sub(t, t, V, f);
    mod_sub(t, t, V, f);          // X3 = r^2 - J - 2V
    mod_sub(t2, V, t, f);
    mont_mul(t2, rr, t2, f);      // r*(V - X3)
    u64 t3[4];
    mont_mul(t3, r.Y, J, f);
    mod_add(t3, t3, t3, f);       // 2*Y1*J
    mod_sub(r.Y, t2, t3, f);
    std::memcpy(r.X, t, 32);
    mont_mul(t, r.Z, H, f);
    mod_add(r.Z, t, t, f);        // Z3 = 2*Z1*H (madd-2007-bl)
}

static int msm_window(long n) {
    // Pick c minimizing estimated mont_muls: ceil(256/c) windows, each a
    // batch-affine bucket accumulation (~6.5 muls per point: 1 sub + 3
    // amortized batch-inversion muls + 2 muls + 1 sqr) plus a 2^c mixed+full
    // suffix-sum bucket reduction (~27 muls per bucket).
    int best_c = 4;
    double best = 1e30;
    for (int c = 4; c <= 16; c++) {
        double windows = (256 + c - 1) / c;
        double cost = windows * ((double)n * 6.5 + (double)(1L << c) * 27.0);
        if (cost < best) { best = cost; best_c = c; }
    }
    return best_c;
}

// --- batch-affine bucket accumulation ----------------------------------------
// One Pippenger window: counting-sort the points by digit, then reduce each
// bucket by layered PAIRWISE affine additions — every layer's additions are
// independent, so one Montgomery batch inversion serves the whole layer
// (~6.5 muls per addition vs ~11 for a Jacobian mixed add). Exceptional
// pairs (equal or inverse points) take the doubling/infinity branch on the
// same shared inversion. Output: wsum = sum_d d * B_d (Jacobian).

struct LPoint {  // layer point: Montgomery affine + infinity flag
    u64 X[4], Y[4];
    bool inf;
};

static void window_sum_affine(const Field& f, const std::vector<APoint>& ap,
                              const u64* scalars, long n, int c, int bit0,
                              JPoint& out) {
    long nbuckets = 1L << c;
    // counting sort of point indices by digit (digit 0 dropped)
    std::vector<long> count(nbuckets, 0);
    std::vector<int> dig(n);
    for (long i = 0; i < n; i++) {
        int d = 0;
        if (!ap[i].inf) {
            const u64* s = scalars + 4 * i;
            int limb = bit0 / 64, off = bit0 % 64;
            u64 v = s[limb] >> off;
            if (off + c > 64 && limb < 3) v |= s[limb + 1] << (64 - off);
            d = (int)(v & (u64)(nbuckets - 1));
        }
        dig[i] = d;
        if (d) count[d]++;
    }
    std::vector<long> start(nbuckets + 1, 0);
    for (long d = 1; d < nbuckets; d++) start[d + 1] = start[d] + count[d];
    long total = start[nbuckets];
    std::vector<LPoint> layer(total);
    {
        std::vector<long> cur(start.begin(), start.end() - 1);
        for (long i = 0; i < n; i++) {
            int d = dig[i];
            if (!d) continue;
            LPoint& L = layer[cur[d]++];
            std::memcpy(L.X, ap[i].X, 32);
            std::memcpy(L.Y, ap[i].Y, 32);
            L.inf = false;
        }
    }
    // bucket boundaries as (start, len) over `layer`
    std::vector<long> bstart(nbuckets), blen(nbuckets);
    for (long d = 1; d < nbuckets; d++) {
        bstart[d] = start[d];
        blen[d] = count[d];
    }
    // scratch for pairwise reduction
    std::vector<LPoint> next(total ? (total + 1) / 2 + nbuckets : 0);
    std::vector<u64> es;     // elements to invert
    std::vector<u64> pre;    // prefix products
    bool more = true;
    while (more) {
        more = false;
        // collect pairs: for each bucket, pair adjacent points
        long npairs = 0;
        for (long d = 1; d < nbuckets; d++) npairs += blen[d] / 2;
        if (!npairs) break;
        es.assign(4 * npairs, 0);
        struct PairRef { long d; long a; long b; int kind; };  // kind: 0 add, 1 dbl, 2 inf
        std::vector<PairRef> prs(npairs);
        long pi = 0;
        u64 zero[4] = {0, 0, 0, 0};
        for (long d = 1; d < nbuckets; d++) {
            long s0 = bstart[d];
            for (long j = 0; j + 1 < blen[d]; j += 2) {
                LPoint& A = layer[s0 + j];
                LPoint& B = layer[s0 + j + 1];
                PairRef& pr = prs[pi];
                pr.d = d;
                pr.a = s0 + j;
                pr.b = s0 + j + 1;
                u64* e = es.data() + 4 * pi;
                if (A.inf || B.inf) {
                    pr.kind = 2;  // passthrough handled at emit
                    e[0] = 1;
                } else {
                    u64 dx[4];
                    mod_sub(dx, B.X, A.X, f);
                    if (is_zero4(dx)) {
                        u64 dy[4];
                        mod_sub(dy, B.Y, A.Y, f);
                        if (is_zero4(dy)) {
                            pr.kind = 1;  // double: invert 2*y
                            u64 y2[4];
                            mod_add(y2, A.Y, A.Y, f);
                            std::memcpy(e, y2, 32);
                        } else {
                            pr.kind = 2;  // P + (-P) = infinity
                            e[0] = 1;
                        }
                    } else {
                        pr.kind = 0;
                        std::memcpy(e, dx, 32);
                    }
                }
                pi++;
            }
        }
        // batch inversion over es
        pre.assign(4 * npairs, 0);
        std::memcpy(pre.data(), es.data(), 32);
        for (long i = 1; i < npairs; i++)
            mont_mul(pre.data() + 4 * i, pre.data() + 4 * (i - 1),
                     es.data() + 4 * i, f);
        u64 inv[4];
        mont_inv(inv, pre.data() + 4 * (npairs - 1), f);
        std::vector<u64> einv(4 * npairs);
        for (long i = npairs - 1; i >= 1; i--) {
            mont_mul(einv.data() + 4 * i, inv, pre.data() + 4 * (i - 1), f);
            mont_mul(inv, inv, es.data() + 4 * i, f);
        }
        std::memcpy(einv.data(), inv, 32);
        // emit next layer, bucket by bucket (pairs stay in bucket order)
        long w = 0;
        pi = 0;
        std::vector<long> nstart(nbuckets), nlen(nbuckets);
        for (long d = 1; d < nbuckets; d++) {
            nstart[d] = w;
            long s0 = bstart[d], len = blen[d];
            for (long j = 0; j + 1 < len; j += 2) {
                const PairRef& pr = prs[pi];
                const u64* ei = einv.data() + 4 * pi;
                pi++;
                LPoint& A = layer[pr.a];
                LPoint& B = layer[pr.b];
                LPoint& O = next[w];
                if (pr.kind == 2) {
                    if (A.inf && B.inf) {
                        O.inf = true;
                    } else if (A.inf) {
                        O = B;
                    } else if (B.inf) {
                        O = A;
                    } else {
                        O.inf = true;  // cancellation
                    }
                    w++;
                    continue;
                }
                u64 lam[4], t[4];
                if (pr.kind == 1) {  // double: lam = 3 x^2 * (2y)^-1
                    u64 x2[4];
                    mont_sqr(x2, A.X, f);
                    mod_add(t, x2, x2, f);
                    mod_add(t, t, x2, f);
                    mont_mul(lam, t, ei, f);
                } else {  // add: lam = (y2 - y1) * (x2 - x1)^-1
                    mod_sub(t, B.Y, A.Y, f);
                    mont_mul(lam, t, ei, f);
                }
                u64 x3[4], y3[4];
                mont_sqr(x3, lam, f);
                mod_sub(x3, x3, A.X, f);
                mod_sub(x3, x3, B.X, f);
                mod_sub(t, A.X, x3, f);
                mont_mul(t, lam, t, f);
                mod_sub(y3, t, A.Y, f);
                std::memcpy(O.X, x3, 32);
                std::memcpy(O.Y, y3, 32);
                O.inf = false;
                w++;
            }
            if (len & 1) {  // odd leftover carries up unchanged
                next[w++] = layer[s0 + len - 1];
            }
            nlen[d] = w - nstart[d];
            if (nlen[d] > 1) more = true;
        }
        layer.swap(next);
        bstart.swap(nstart);
        blen.swap(nlen);
        if ((long)next.size() < (w + 1) / 2 + nbuckets)
            next.resize((w + 1) / 2 + nbuckets);
    }
    // suffix-sum reduction: out = sum_d d * B_d
    JPoint running, tot;
    jset_identity(running, f);
    jset_identity(tot, f);
    for (long d = nbuckets - 1; d >= 1; d--) {
        if (blen[d]) {
            const LPoint& L = layer[bstart[d]];
            if (!L.inf) {
                APoint a;
                std::memcpy(a.X, L.X, 32);
                std::memcpy(a.Y, L.Y, 32);
                a.inf = false;
                jadd_mixed(running, a, f);
            }
        }
        jadd(tot, tot, running, f);
    }
    out = tot;
}

static void msm_pippenger(int field_id, u64* out, const u64* pts,
                          const u64* scalars, long n) {
    const Field& f = g_fields[field_id];
    int c = msm_window(n);
    int n_windows = (256 + c - 1) / c;
    long nbuckets = 1L << c;

    // Montgomery affine copies
    std::vector<APoint> ap(n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const u64* p = pts + 9 * i;
        ap[i].inf = p[8] != 0;
        if (!ap[i].inf) {
            to_mont(ap[i].X, p, f);
            to_mont(ap[i].Y, p + 4, f);
        }
    }

    std::vector<JPoint> wsum(n_windows);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int w = 0; w < n_windows; w++)
        window_sum_affine(f, ap, scalars, n, c, w * c, wsum[w]);

    JPoint acc;
    jset_identity(acc, f);
    for (int w = n_windows - 1; w >= 0; w--) {
        for (int d = 0; d < c && w != n_windows - 1; d++) jdouble(acc, acc, f);
        jadd(acc, acc, wsum[w], f);
    }
    jto_affine(out, acc, f);
}

// --- NTT over the 2^k domain ------------------------------------------------
// In-place radix-2 DIT over Montgomery-form data (B rows of n = 2^k values).
// omega supplied in PLAIN form. Per-stage CONTIGUOUS twiddle tables (stage s
// reads its 2^{s-1} twiddles sequentially — the strided W[j*tstep] indexing
// of the naive layout thrashes cache at 2^16 domains), cached across calls
// keyed by (field, k, omega): the prover transforms dozens of rows per proof
// over the same three domains.

struct NttPlan {
    int field_id = -1;
    int k = -1;
    u64 om0 = 0, om1 = 0;
    std::vector<u64> stage_tw;     // concatenated per-stage tables, 4*(n-1)
    std::vector<long> stage_off;   // offset (in elements) of stage s's table
    std::vector<long> rev;         // bit-reversal permutation
};

static NttPlan g_ntt_plans[8];
static int g_ntt_plan_clock = 0;

static NttPlan* ntt_plan(int field_id, int k, const u64* omega_plain) {
    const Field& f = g_fields[field_id];
    long n = 1L << k;
    for (auto& pl : g_ntt_plans) {
        if (pl.field_id == field_id && pl.k == k && pl.om0 == omega_plain[0] &&
            pl.om1 == omega_plain[1])
            return &pl;
    }
    NttPlan& pl = g_ntt_plans[g_ntt_plan_clock];
    g_ntt_plan_clock = (g_ntt_plan_clock + 1) % 8;
    pl.field_id = field_id;
    pl.k = k;
    pl.om0 = omega_plain[0];
    pl.om1 = omega_plain[1];
    u64 om[4];
    to_mont(om, omega_plain, f);
    pl.stage_tw.assign(4 * (n - 1), 0);
    pl.stage_off.assign(k + 1, 0);
    u64 one[4] = {1, 0, 0, 0};
    long off = 0;
    for (int s = 1; s <= k; s++) {
        long half = 1L << (s - 1);
        pl.stage_off[s] = off;
        // wm = omega^(n/2^s); table[j] = wm^j
        u64 wm[4];
        std::memcpy(wm, om, 32);
        for (int d = 0; d < k - s; d++) mont_sqr(wm, wm, f);
        u64* tw = pl.stage_tw.data() + 4 * off;
        to_mont(tw, one, f);
        for (long j = 1; j < half; j++)
            mont_mul(tw + 4 * j, tw + 4 * (j - 1), wm, f);
        off += half;
    }
    pl.rev.assign(n, 0);
    for (long i = 0; i < n; i++) {
        long r = 0;
        for (int b = 0; b < k; b++) r |= ((i >> b) & 1) << (k - 1 - b);
        pl.rev[i] = r;
    }
    return &pl;
}

static void ntt_one_row(u64* d, const NttPlan& pl, const Field& f, long n,
                        int k) {
    for (long i = 0; i < n; i++) {
        long r = pl.rev[i];
        if (r > i) {
            u64 t[4];
            std::memcpy(t, d + 4 * i, 32);
            std::memcpy(d + 4 * i, d + 4 * r, 32);
            std::memcpy(d + 4 * r, t, 32);
        }
    }
    for (int s = 1; s <= k; s++) {
        long mlen = 1L << s, half = mlen >> 1;
        const u64* tw = pl.stage_tw.data() + 4 * pl.stage_off[s];
        for (long g = 0; g < n; g += mlen) {
            for (long j = 0; j < half; j++) {
                const u64* wj = tw + 4 * j;
                u64* a = d + 4 * (g + j);
                u64* b = d + 4 * (g + j + half);
                u64 t[4];
                mont_mul(t, b, wj, f);
                mod_sub(b, a, t, f);
                mod_add(a, a, t, f);
            }
        }
    }
}

static void ntt_rows(int field_id, u64* data, long rows, int k,
                     const u64* omega_plain, int inverse) {
    const Field& f = g_fields[field_id];
    long n = 1L << k;
    NttPlan* pl;
#ifdef _OPENMP
#pragma omp critical(ntt_plan)
#endif
    pl = ntt_plan(field_id, k, omega_plain);
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
#endif
    if (rows >= nthreads || n < (1L << 12)) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (long row = 0; row < rows; row++)
            ntt_one_row(data + 4 * n * row, *pl, f, n, k);
    } else {
        // few big rows: parallelize butterflies inside each stage
        for (long row = 0; row < rows; row++) {
            u64* d = data + 4 * n * row;
#ifdef _OPENMP
#pragma omp parallel
#endif
            {
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
                for (long i = 0; i < n; i++) {
                    long r = pl->rev[i];
                    if (r > i) {
                        u64 t[4];
                        std::memcpy(t, d + 4 * i, 32);
                        std::memcpy(d + 4 * i, d + 4 * r, 32);
                        std::memcpy(d + 4 * r, t, 32);
                    }
                }
                for (int s = 1; s <= k; s++) {
                    long mlen = 1L << s, half = mlen >> 1;
                    long nb = n >> s;  // butterfly groups
                    const u64* tw = pl->stage_tw.data() + 4 * pl->stage_off[s];
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
                    for (long g = 0; g < nb; g++) {
                        u64* base = d + 4 * g * mlen;
                        for (long j = 0; j < half; j++) {
                            const u64* wj = tw + 4 * j;
                            u64* a = base + 4 * j;
                            u64* b = base + 4 * (j + half);
                            u64 t[4];
                            mont_mul(t, b, wj, f);
                            mod_sub(b, a, t, f);
                            mod_add(a, a, t, f);
                        }
                    }
                }
            }
        }
    }
    if (inverse) {
        // caller passes omega^{-1} as the twiddle root for an inverse
        // transform; the flag only applies the final n^{-1} scaling.
        u64 ninv[4];
        u64 nv[4] = {(u64)n, 0, 0, 0};
        u64 nm[4];
        to_mont(nm, nv, f);
        mont_inv(ninv, nm, f);
        long total = rows * n;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (long i = 0; i < total; i++) {
            u64 t[4];
            mont_mul(t, data + 4 * i, ninv, f);
            std::memcpy(data + 4 * i, t, 32);
        }
    }
}

// --- Montgomery vector ops (data stays in Montgomery form across calls) -----

extern "C" {

// Batched MSM: out = sum_i [scalars[i]] pts[i]; pts n*9 u64, scalars n*4 u64.
void taiga_ec_msm(int field_id, u64* out, const u64* pts, const u64* scalars,
                  long n) {
    msm_pippenger(field_id, out, pts, scalars, n);
}

// C MSMs over the SAME base points (the prover's per-column commitments):
// scalars (C, n, 4) plain, out (C, 9). Base converted to Montgomery once;
// (column, window) tasks threaded — better load balance than per-column
// serial Pippenger calls.
void taiga_ec_msm_many(int field_id, u64* out, const u64* pts,
                       const u64* scalars, long C, long n) {
    const Field& f = g_fields[field_id];
    int c = msm_window(n);
    int n_windows = (256 + c - 1) / c;
    long nbuckets = 1L << c;

    std::vector<APoint> ap(n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const u64* p = pts + 9 * i;
        ap[i].inf = p[8] != 0;
        if (!ap[i].inf) {
            to_mont(ap[i].X, p, f);
            to_mont(ap[i].Y, p + 4, f);
        }
    }

    std::vector<JPoint> wsum((size_t)C * n_windows);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (long task = 0; task < C * n_windows; task++) {
        long col = task / n_windows;
        int w = (int)(task % n_windows);
        const u64* sc = scalars + 4 * n * col;
        window_sum_affine(f, ap, sc, n, c, w * c, wsum[task]);
    }

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long col = 0; col < C; col++) {
        JPoint acc;
        jset_identity(acc, f);
        for (int w = n_windows - 1; w >= 0; w--) {
            for (int d = 0; d < c && w != n_windows - 1; d++)
                jdouble(acc, acc, f);
            jadd(acc, acc, wsum[(size_t)col * n_windows + w], f);
        }
        jto_affine(out + 9 * col, acc, f);
    }
}

void taiga_vec_to_mont(int field_id, u64* out, const u64* a, long n) {
    const Field& f = g_fields[field_id];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32768)
#endif
    for (long i = 0; i < n; i++) to_mont(out + 4 * i, a + 4 * i, f);
}

void taiga_vec_from_mont(int field_id, u64* out, const u64* a, long n) {
    const Field& f = g_fields[field_id];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32768)
#endif
    for (long i = 0; i < n; i++) from_mont(out + 4 * i, a + 4 * i, f);
}

// out = a op b elementwise (Montgomery form for mul). b may be a single
// element broadcast when b_stride == 0.
void taiga_vec_mul(int field_id, u64* out, const u64* a, const u64* b,
                   long n, long b_stride) {
    const Field& f = g_fields[field_id];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32768)
#endif
    for (long i = 0; i < n; i++)
        mont_mul(out + 4 * i, a + 4 * i, b + 4 * i * b_stride, f);
}

void taiga_vec_add(int field_id, u64* out, const u64* a, const u64* b,
                   long n, long b_stride) {
    const Field& f = g_fields[field_id];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32768)
#endif
    for (long i = 0; i < n; i++)
        mod_add(out + 4 * i, a + 4 * i, b + 4 * i * b_stride, f);
}

void taiga_vec_sub(int field_id, u64* out, const u64* a, const u64* b,
                   long n, long b_stride) {
    const Field& f = g_fields[field_id];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32768)
#endif
    for (long i = 0; i < n; i++)
        mod_sub(out + 4 * i, a + 4 * i, b + 4 * i * b_stride, f);
}

// Inclusive cumulative product (Montgomery), sequential by nature.
void taiga_vec_cumprod(int field_id, u64* out, const u64* a, long n) {
    const Field& f = g_fields[field_id];
    if (n == 0) return;
    std::memcpy(out, a, 32);
    for (long i = 1; i < n; i++)
        mont_mul(out + 4 * i, out + 4 * (i - 1), a + 4 * i, f);
}

// Batched inversion (Montgomery trick): out_i = a_i^{-1}, a_i != 0.
void taiga_vec_batch_inv(int field_id, u64* out, const u64* a, long n) {
    const Field& f = g_fields[field_id];
    if (n == 0) return;
    std::vector<u64> pre(4 * n);
    std::memcpy(pre.data(), a, 32);
    for (long i = 1; i < n; i++)
        mont_mul(pre.data() + 4 * i, pre.data() + 4 * (i - 1), a + 4 * i, f);
    u64 inv[4];
    mont_inv(inv, pre.data() + 4 * (n - 1), f);
    for (long i = n - 1; i >= 1; i--) {
        mont_mul(out + 4 * i, inv, pre.data() + 4 * (i - 1), f);
        mont_mul(inv, inv, a + 4 * i, f);
    }
    std::memcpy(out, inv, 32);
}

// out[1..n] = [1, x, x^2, ...]: n powers of x (Montgomery form).
void taiga_vec_powers(int field_id, u64* out, const u64* x_mont, long n) {
    const Field& f = g_fields[field_id];
    if (n == 0) return;
    u64 one[4] = {1, 0, 0, 0};
    to_mont(out, one, f);
    for (long i = 1; i < n; i++)
        mont_mul(out + 4 * i, out + 4 * (i - 1), x_mont, f);
}

// Single Fermat inversion of one Montgomery element.
void taiga_mont_inv_one(int field_id, u64* out, const u64* a) {
    mont_inv(out, a, g_fields[field_id]);
}

// Forward/inverse NTT over rows (Montgomery form in/out).
void taiga_ntt(int field_id, u64* data, long rows, int k,
               const u64* omega_plain, int inverse) {
    ntt_rows(field_id, data, rows, k, omega_plain, inverse);
}

// out = -a elementwise (mod p).
void taiga_vec_neg(int field_id, u64* out, const u64* a, long n) {
    const Field& f = g_fields[field_id];
    u64 zero[4] = {0, 0, 0, 0};
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32768)
#endif
    for (long i = 0; i < n; i++) mod_sub(out + 4 * i, zero, a + 4 * i, f);
}

// out (4 u64) = sum_i a_i mod p.
void taiga_vec_sum(int field_id, u64* out, const u64* a, long n) {
    const Field& f = g_fields[field_id];
    u64 acc[4] = {0, 0, 0, 0};
    for (long i = 0; i < n; i++) mod_add(acc, acc, a + 4 * i, f);
    std::memcpy(out, acc, 32);
}

// Synthetic division: given coeffs a_0..a_{n-1} (Montgomery) and a point x
// (Montgomery), write q with q_i st A(X) - A(x) = (X - x) q(X); q_{n-1} = 0.
// Backward Horner: q_{n-2} = a_{n-1}; q_{i-1} = a_i + x*q_i.
void taiga_poly_divide(int field_id, u64* out, const u64* coeffs,
                       const u64* x_mont, long n) {
    const Field& f = g_fields[field_id];
    std::memset(out + 4 * (n - 1), 0, 32);
    if (n < 2) return;
    std::memcpy(out + 4 * (n - 2), coeffs + 4 * (n - 1), 32);
    for (long i = n - 2; i >= 1; i--) {
        u64 t[4];
        mont_mul(t, out + 4 * i, x_mont, f);
        mod_add(out + 4 * (i - 1), t, coeffs + 4 * i, f);
    }
}

// Pointwise EC fold: out_i = lo_i + [scalar] hi_i over n affine plain-form
// points (9 u64 rows); result normalized back to affine via batched
// inversion. The IPA prover's generator fold.
void taiga_ec_fold(int field_id, u64* out, const u64* lo, const u64* hi,
                   const u64* scalar, long n) {
    const Field& f = g_fields[field_id];
    std::vector<JPoint> res(n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        JPoint H, R;
        jfrom_affine(H, hi + 9 * i, f);
        jset_identity(R, f);
        for (int b = 255; b >= 0; b--) {
            jdouble(R, R, f);
            if ((scalar[b / 64] >> (b % 64)) & 1) jadd(R, R, H, f);
        }
        JPoint Lo;
        jfrom_affine(Lo, lo + 9 * i, f);
        jadd(res[i], Lo, R, f);
    }
    // batched affine normalization: invert all Z via Montgomery trick
    std::vector<u64> zs(4 * n);
    long m = 0;
    std::vector<long> idx(n);
    for (long i = 0; i < n; i++) {
        if (!is_zero4(res[i].Z)) {
            std::memcpy(zs.data() + 4 * m, res[i].Z, 32);
            idx[m++] = i;
        } else {
            std::memset(out + 9 * i, 0, 64);
            out[9 * i + 8] = 1;
        }
    }
    if (m) {
        std::vector<u64> zinv(4 * m);
        // prefix products
        std::vector<u64> pre(4 * m);
        std::memcpy(pre.data(), zs.data(), 32);
        for (long i = 1; i < m; i++)
            mont_mul(pre.data() + 4 * i, pre.data() + 4 * (i - 1), zs.data() + 4 * i, f);
        u64 inv[4];
        mont_inv(inv, pre.data() + 4 * (m - 1), f);
        for (long i = m - 1; i >= 1; i--) {
            mont_mul(zinv.data() + 4 * i, inv, pre.data() + 4 * (i - 1), f);
            mont_mul(inv, inv, zs.data() + 4 * i, f);
        }
        std::memcpy(zinv.data(), inv, 32);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (long j = 0; j < m; j++) {
            long i = idx[j];
            u64 zi2[4], zi3[4], t[4];
            mont_sqr(zi2, zinv.data() + 4 * j, f);
            mont_mul(zi3, zi2, zinv.data() + 4 * j, f);
            mont_mul(t, res[i].X, zi2, f);
            from_mont(out + 9 * i, t, f);
            mont_mul(t, res[i].Y, zi3, f);
            from_mont(out + 9 * i + 4, t, f);
            out[9 * i + 8] = 0;
        }
    }
}

// GLV + wNAF generator fold: out_i = lo_i + [k] hi_i where the caller has
// split k = s1*|k1| + s2*|k2|*lam (|ki| ~ 2^128) and passes zeta (plain) with
// phi(x, y) = (zeta x, y) = [lam](x, y). Joint 4-wide wNAF over both halves
// shares ONE ~130-step double chain per point — ~1.7x fewer field muls than
// the 255-bit double-and-add in taiga_ec_fold.
static void wnaf_digits(const u64 k[4], int w, signed char* out, int* len) {
    // k as little-endian 4x64; digits odd in (-2^(w-1), 2^(w-1)), w <= 8
    u64 v[5] = {k[0], k[1], k[2], k[3], 0};
    int n = 0;
    auto is_zero = [&]() {
        return !(v[0] | v[1] | v[2] | v[3] | v[4]);
    };
    auto shr1 = [&]() {
        for (int i = 0; i < 4; i++) v[i] = (v[i] >> 1) | (v[i + 1] << 63);
        v[4] >>= 1;
    };
    auto sub_small = [&](long d) {
        if (d >= 0) {
            u64 borrow = (u64)d;
            for (int i = 0; i < 5 && borrow; i++) {
                u64 nv = v[i] - borrow;
                borrow = nv > v[i] ? 1 : 0;
                v[i] = nv;
            }
        } else {
            u64 carry = (u64)(-d);
            for (int i = 0; i < 5 && carry; i++) {
                u64 nv = v[i] + carry;
                carry = nv < v[i] ? 1 : 0;
                v[i] = nv;
            }
        }
    };
    long full = 1L << w, half = 1L << (w - 1);
    while (!is_zero()) {
        if (v[0] & 1) {
            long d = (long)(v[0] & (u64)(full - 1));
            if (d >= half) d -= full;
            out[n++] = (signed char)d;
            sub_small(d);
        } else {
            out[n++] = 0;
        }
        shr1();
    }
    *len = n;
}

void taiga_ec_fold2(int field_id, u64* out, const u64* lo, const u64* hi,
                    const u64* k1_abs, int k1_neg, const u64* k2_abs,
                    int k2_neg, const u64* zeta_plain, long n) {
    const Field& f = g_fields[field_id];
    u64 zeta[4];
    to_mont(zeta, zeta_plain, f);
    signed char d1[264], d2[264];
    int l1 = 0, l2 = 0;
    wnaf_digits(k1_abs, 4, d1, &l1);
    wnaf_digits(k2_abs, 4, d2, &l2);
    int L = l1 > l2 ? l1 : l2;
    std::vector<JPoint> res(n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const u64* h = hi + 9 * i;
        JPoint Lo;
        jfrom_affine(Lo, lo + 9 * i, f);
        if (h[8]) {  // hi at infinity: result = lo
            res[i] = Lo;
            continue;
        }
        // Montgomery affine bases B1 = +-H, B2 = +-phi(H)
        APoint b1, b2;
        b1.inf = b2.inf = false;
        to_mont(b1.X, h, f);
        to_mont(b1.Y, h + 4, f);
        u64 zero[4] = {0, 0, 0, 0};
        if (k1_neg) mod_sub(b1.Y, zero, b1.Y, f);
        mont_mul(b2.X, b1.X, zeta, f);
        to_mont(b2.Y, h + 4, f);
        if (k2_neg) mod_sub(b2.Y, zero, b2.Y, f);
        // Jacobian odd-multiple tables {1,3,5,7} * B
        JPoint t1[4], t2[4];
        u64 one_m[4];
        u64 one_p[4] = {1, 0, 0, 0};
        to_mont(one_m, one_p, f);
        auto build = [&](const APoint& b, JPoint* t) {
            std::memcpy(t[0].X, b.X, 32);
            std::memcpy(t[0].Y, b.Y, 32);
            std::memcpy(t[0].Z, one_m, 32);
            JPoint d2x;
            jdouble(d2x, t[0], f);
            for (int j = 1; j < 4; j++) jadd(t[j], t[j - 1], d2x, f);
        };
        build(b1, t1);
        build(b2, t2);
        JPoint R;
        jset_identity(R, f);
        for (int b = L - 1; b >= 0; b--) {
            jdouble(R, R, f);
            if (b < l1 && d1[b]) {
                int d = d1[b];
                JPoint t = t1[(d > 0 ? d : -d) >> 1];
                if (d < 0) mod_sub(t.Y, zero, t.Y, f);
                jadd(R, R, t, f);
            }
            if (b < l2 && d2[b]) {
                int d = d2[b];
                JPoint t = t2[(d > 0 ? d : -d) >> 1];
                if (d < 0) mod_sub(t.Y, zero, t.Y, f);
                jadd(R, R, t, f);
            }
        }
        jadd(res[i], Lo, R, f);
    }
    // batched affine normalization (shared with taiga_ec_fold)
    std::vector<u64> zs(4 * n);
    long m = 0;
    std::vector<long> idx(n);
    for (long i = 0; i < n; i++) {
        if (!is_zero4(res[i].Z)) {
            std::memcpy(zs.data() + 4 * m, res[i].Z, 32);
            idx[m++] = i;
        } else {
            std::memset(out + 9 * i, 0, 64);
            out[9 * i + 8] = 1;
        }
    }
    if (m) {
        std::vector<u64> zinv(4 * m);
        std::vector<u64> pre(4 * m);
        std::memcpy(pre.data(), zs.data(), 32);
        for (long i = 1; i < m; i++)
            mont_mul(pre.data() + 4 * i, pre.data() + 4 * (i - 1),
                     zs.data() + 4 * i, f);
        u64 inv[4];
        mont_inv(inv, pre.data() + 4 * (m - 1), f);
        for (long i = m - 1; i >= 1; i--) {
            mont_mul(zinv.data() + 4 * i, inv, pre.data() + 4 * (i - 1), f);
            mont_mul(inv, inv, zs.data() + 4 * i, f);
        }
        std::memcpy(zinv.data(), inv, 32);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (long j = 0; j < m; j++) {
            long i = idx[j];
            u64 zi2[4], zi3[4], t[4];
            mont_sqr(zi2, zinv.data() + 4 * j, f);
            mont_mul(zi3, zi2, zinv.data() + 4 * j, f);
            mont_mul(t, res[i].X, zi2, f);
            from_mont(out + 9 * i, t, f);
            mont_mul(t, res[i].Y, zi3, f);
            from_mont(out + 9 * i + 4, t, f);
            out[9 * i + 8] = 0;
        }
    }
}

// --- flat-tape constraint evaluator -----------------------------------------
// Executes a compiled expression tape (plonk/tape.py) over the whole domain:
// the quotient numerator's Horner-in-y accumulation in ONE native call.
// code rows: (op, dst, a, b, c) int32. Ops: 0 LOAD dst<-tables[a][b] rot c;
// 1 ADD dst<-r[a]+r[b]; 2 ADDS dst<-r[a]+scalar[b]; 3 MUL dst<-r[a]*r[b];
// 4 MULS dst<-r[a]*scalar[b]; 5 NEG dst<--r[a].
// tables: array of T pointers, tables[t] = (cols_t, domain, 4) u64 Montgomery,
// contiguous. scalars: (S, 4) Montgomery. out: (domain, 4) — register
// `out_reg` after the last instruction. Chunked; OpenMP over chunks.
void taiga_tape_eval(int field_id, u64* out, const int32_t* code, long n_ins,
                     const u64* scalars, const u64* const* tables,
                     long domain, int num_regs, int out_reg) {
    const Field& f = g_fields[field_id];
    const long CH = 1024 < domain ? 1024 : domain;
    const long n_chunks = (domain + CH - 1) / CH;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<u64> regs((size_t)num_regs * CH * 4);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (long ch = 0; ch < n_chunks; ch++) {
            const long base = ch * CH;
            const long len = (base + CH <= domain) ? CH : (domain - base);
            for (long ins = 0; ins < n_ins; ins++) {
                const int32_t* I = code + 5 * ins;
                const int op = I[0];
                u64* dst = regs.data() + (size_t)I[1] * CH * 4;
                if (op == 0) {  // LOAD
                    const u64* tbl = tables[I[2]];
                    const u64* col = tbl + (size_t)I[3] * domain * 4;
                    long rot = I[4] % domain;
                    if (rot < 0) rot += domain;
                    long src = base + rot;
                    if (src >= domain) src -= domain;
                    long first = domain - src;
                    if (first >= len) {
                        std::memcpy(dst, col + 4 * src, (size_t)len * 32);
                    } else {
                        std::memcpy(dst, col + 4 * src, (size_t)first * 32);
                        std::memcpy(dst + 4 * first, col,
                                    (size_t)(len - first) * 32);
                    }
                } else if (op == 1) {  // ADD
                    const u64* a = regs.data() + (size_t)I[2] * CH * 4;
                    const u64* b = regs.data() + (size_t)I[3] * CH * 4;
                    for (long i = 0; i < len; i++)
                        mod_add(dst + 4 * i, a + 4 * i, b + 4 * i, f);
                } else if (op == 2) {  // ADDS
                    const u64* a = regs.data() + (size_t)I[2] * CH * 4;
                    const u64* s = scalars + 4 * I[3];
                    for (long i = 0; i < len; i++)
                        mod_add(dst + 4 * i, a + 4 * i, s, f);
                } else if (op == 3) {  // MUL
                    const u64* a = regs.data() + (size_t)I[2] * CH * 4;
                    const u64* b = regs.data() + (size_t)I[3] * CH * 4;
                    for (long i = 0; i < len; i++)
                        mont_mul(dst + 4 * i, a + 4 * i, b + 4 * i, f);
                } else if (op == 4) {  // MULS
                    const u64* a = regs.data() + (size_t)I[2] * CH * 4;
                    const u64* s = scalars + 4 * I[3];
                    for (long i = 0; i < len; i++)
                        mont_mul(dst + 4 * i, a + 4 * i, s, f);
                } else {  // NEG
                    const u64* a = regs.data() + (size_t)I[2] * CH * 4;
                    u64 zero[4] = {0, 0, 0, 0};
                    for (long i = 0; i < len; i++)
                        mod_sub(dst + 4 * i, zero, a + 4 * i, f);
                }
            }
            std::memcpy(out + 4 * base,
                        regs.data() + (size_t)out_reg * CH * 4,
                        (size_t)len * 32);
        }
    }
}

// --- batched point decompression --------------------------------------------
// pasta compressed form: 32 bytes = x (31.875 bytes LE) with the y-parity in
// the top bit. y = sqrt(x^3 + 5) via Tonelli-Shanks (both pasta fields have
// 2-adicity 32, so the p == 3 mod 4 shortcut does not apply). The Python
// verifier's per-point sqrt (~0.5 ms each, ~66 points/proof) was the largest
// single verify cost; this runs the whole batch in one call.

struct SqrtPlan {
    bool init = false;
    u64 t_odd[4];   // p - 1 = t * 2^S, t odd
    u64 tp1h[4];    // (t + 1) / 2
    int S = 0;
    u64 z0[4];      // nonresidue^t (Montgomery) — generator of the 2-Sylow
};
static SqrtPlan g_sqrt[2];

static void shr1_4(u64 v[4]) {
    for (int i = 0; i < 3; i++) v[i] = (v[i] >> 1) | (v[i + 1] << 63);
    v[3] >>= 1;
}

static SqrtPlan& sqrt_plan(int field_id) {
    SqrtPlan& sp = g_sqrt[field_id];
    if (sp.init) return sp;
    const Field& f = g_fields[field_id];
    u64 t[4];
    std::memcpy(t, f.mod, 32);
    t[0] -= 1;  // p odd, no borrow
    int S = 0;
    while (!(t[0] & 1)) { shr1_4(t); S++; }
    std::memcpy(sp.t_odd, t, 32);
    u64 th[4];
    std::memcpy(th, t, 32);
    th[0] += 1;  // t odd -> t+1 even, no overflow past limb 0 carry chain?
    // (t+1) may carry: t odd means t[0]+1 can't overflow only if t[0]!=~0;
    // handle the carry properly:
    if (th[0] == 0) { for (int i = 1; i < 4; i++) { if (++th[i]) break; } }
    shr1_4(th);
    std::memcpy(sp.tp1h, th, 32);
    sp.S = S;
    // find a quadratic nonresidue c: c^((p-1)/2) == -1
    u64 pm1h[4];
    std::memcpy(pm1h, f.mod, 32);
    pm1h[0] -= 1;
    shr1_4(pm1h);
    u64 one_m[4], m1_m[4];
    u64 one_p[4] = {1, 0, 0, 0};
    to_mont(one_m, one_p, f);
    u64 zero[4] = {0, 0, 0, 0};
    mod_sub(m1_m, zero, one_m, f);
    for (u64 c = 2;; c++) {
        u64 cp[4] = {c, 0, 0, 0};
        u64 cm[4], e[4];
        to_mont(cm, cp, f);
        mont_pow(e, cm, pm1h, f);
        if (std::memcmp(e, m1_m, 32) == 0) {
            mont_pow(sp.z0, cm, sp.t_odd, f);
            break;
        }
    }
    sp.init = true;
    return sp;
}

// Montgomery-form Tonelli-Shanks: r with r^2 == a, or false if non-residue.
static bool mont_sqrt(u64 r[4], const u64 a_m[4], const Field& f,
                      const SqrtPlan& sp, const u64 one_m[4]) {
    if (is_zero4(a_m)) { std::memset(r, 0, 32); return true; }
    u64 x[4], b[4], z[4];
    mont_pow(x, a_m, sp.tp1h, f);  // a^((t+1)/2)
    mont_pow(b, a_m, sp.t_odd, f); // a^t
    std::memcpy(z, sp.z0, 32);
    int s = sp.S;
    while (std::memcmp(b, one_m, 32) != 0) {
        int kk = 0;
        u64 bb[4];
        std::memcpy(bb, b, 32);
        while (std::memcmp(bb, one_m, 32) != 0) {
            mont_sqr(bb, bb, f);
            kk++;
            if (kk >= s) return false;  // non-residue (order 2^s exactly)
        }
        u64 zz[4];
        std::memcpy(zz, z, 32);
        for (int i = 0; i < s - kk - 1; i++) mont_sqr(zz, zz, f);
        mont_mul(x, x, zz, f);
        mont_sqr(zz, zz, f);
        mont_mul(b, b, zz, f);
        std::memcpy(z, zz, 32);
        s = kk;
    }
    std::memcpy(r, x, 32);
    return true;
}

// Decompress n points: x_plain (n, 4) little-endian plain coords, signs (n)
// y-parity bits. out_xy (n, 8) plain affine; ok[i] = 1 valid, 0 invalid
// (x >= p or x^3 + b a non-residue). `b_plain` is the curve constant (5).
void taiga_point_decompress(int field_id, u64* out_xy, unsigned char* ok,
                            const u64* x_plain, const unsigned char* signs,
                            const u64* b_plain, long n) {
    const Field& f = g_fields[field_id];
    const SqrtPlan& sp = sqrt_plan(field_id);
    u64 one_p[4] = {1, 0, 0, 0};
    u64 one_m[4];
    to_mont(one_m, one_p, f);
    u64 b_m[4];
    to_mont(b_m, b_plain, f);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const u64* xp = x_plain + 4 * i;
        if (ge4(xp, f.mod)) { ok[i] = 0; continue; }
        u64 xm[4], rhs[4], t[4];
        to_mont(xm, xp, f);
        mont_sqr(t, xm, f);
        mont_mul(rhs, t, xm, f);
        mod_add(rhs, rhs, b_m, f);
        u64 ym[4];
        if (!mont_sqrt(ym, rhs, f, sp, one_m)) { ok[i] = 0; continue; }
        // verify (guards the s>kk early-exit) and fix parity
        mont_sqr(t, ym, f);
        if (std::memcmp(t, rhs, 32) != 0) { ok[i] = 0; continue; }
        u64 yp[4];
        from_mont(yp, ym, f);
        if ((int)(yp[0] & 1) != (int)(signs[i] & 1)) {
            u64 zero[4] = {0, 0, 0, 0};
            mod_sub(ym, zero, ym, f);
            from_mont(yp, ym, f);
        }
        std::memcpy(out_xy + 8 * i, xp, 32);
        std::memcpy(out_xy + 8 * i + 4, yp, 32);
        ok[i] = 1;
    }
}

// Evaluate C coefficient rows at Q points: coeffs (C, n, 4) Montgomery,
// points (Q, 4) Montgomery -> out (Q, C, 4) Montgomery. Horner, threaded.
void taiga_poly_eval_many(int field_id, u64* out, const u64* coeffs,
                          const u64* points, long C, long n, long Q) {
    const Field& f = g_fields[field_id];
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
    for (long q = 0; q < Q; q++) {
        for (long c_i = 0; c_i < C; c_i++) {
            const u64* x = points + 4 * q;
            const u64* a = coeffs + 4 * n * c_i;
            u64 acc[4] = {0, 0, 0, 0};
            for (long j = n - 1; j >= 0; j--) {
                u64 t[4];
                mont_mul(t, acc, x, f);
                mod_add(acc, t, a + 4 * j, f);
            }
            std::memcpy(out + 4 * (q * C + c_i), acc, 32);
        }
    }
}

}  // extern "C"
