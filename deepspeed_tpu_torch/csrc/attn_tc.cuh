// Consumer bodies of the tensor-core attention kernels, shared by the
// dense and the block-sparse kernels: one warpgroup's step over one k-tile
// of the forward (flash_fwd_tc, block_sparse_fwd_tc) with its epilogue,
// over one q-tile of the dK/dV backward (flash_bwd_dkv_tc,
// block_sparse_bwd_dkv_tc), and over one k-tile of the dQ backward
// (flash_bwd_dq_tc, block_sparse_bwd_dq_tc).  The caller owns the TMA
// ring and its barriers and says where the tiles are; the mask is the
// caller's predicate vis(r, c), evaluated (as a select) only on a tile
// the caller calls partial.  Two rules keep the unmasked tiles free of
// mask work: the element loops are instantiated apart for masked and
// unmasked tiles (a `bool MASKED` template parameter; one select inside a
// single unrolled loop let the compiler evaluate the predicate on every
// tile), and the predicate captures by value and combines its tests with
// & and |, not && and || (a short-circuit over a value read through a
// reference, such as a field of the kernel's __grid_constant__
// parameters, compiles to a branch per element).  Fragment row r = 0, 1
// is row fr.row, fr.row + 8 of the warpgroup's 64 M rows (hopper::Frag),
// c the column of the tile (a key of the forward's and dQ's k-tile, a
// query of dK/dV's q-tile).
#pragma once

#include "hopper.cuh"

namespace attn_tc {

// a [rows, D] 16-bit tile in shared memory: HALVES TMA boxes of COLS
// columns, ROWB bytes a box row (hopper.cuh); D 80 and 96 in the boxes of
// D 128 (common.cuh tile_dim), the second one past D zero-filled.  KSTEPS:
// the 16-column depth steps of a product whose depth is D, the exact D.
template <int D>
struct Boxes {
    static constexpr int DT = HeadDim<D>::TILE;
    static constexpr int HALVES = DT > 64 ? DT / 64 : 1;
    static constexpr int COLS = DT < 64 ? DT : 64;
    static constexpr int ROWB = 2 * COLS;
    static constexpr int KSTEPS = D / 16;
    static_assert(HALVES * COLS == DT && KSTEPS * 16 == D && D > (HALVES - 1) * COLS,
                  "the boxes cover D, each of them holds a column of it");
};

constexpr int BK = 64;             // keys per k-tile of the forward and dQ

// The online-softmax state of a warpgroup's 64 query rows: the fp32
// output accumulator fragment, and per fragment row the running max m of
// the scaled scores and this thread's share l of the row sum.
template <int D>
struct FwdState {
    float o[Boxes<D>::HALVES][Boxes<D>::COLS / 2];
    float m[2], l[2];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int hf = 0; hf < Boxes<D>::HALVES; ++hf)
#pragma unroll
            for (int e = 0; e < Boxes<D>::COLS / 2; ++e) o[hf][e] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
    }
};

// The forward's scores times scale, -inf where vis says no (MASKED), and
// each fragment row's max of them
template <bool MASKED, typename Vis>
__device__ __forceinline__ void scale_scores(float (&sc)[BK / 2], float (&mx)[2], float scale,
                                             const hopper::Frag& fr, const Vis& vis) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
        float x = sc[e] * scale;
        if (MASKED) x = vis((e >> 1) & 1, 8 * (e / 4) + fr.col + (e & 1)) ? x : -INFINITY;
        sc[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
}

// One k-tile of the forward.  S = Q.K^T with wgmma (both operands K-major
// in shared memory: q_addr holds this warpgroup's 64 rows of a QR-row Q
// tile, k_addr the 64-key K tile), scaled in fp32 as flash_attention.py
// :165 does, masked by vis where `masked`; the online softmax on the
// accumulator fragment (a row lives in one quad of lanes: two shuffles per
// reduction); O += P.V with wgmma taking P from registers, rounded to T in
// place (JAX p.astype(vs.dtype)), and V (v_addr) as a transposed
// (MN-major) tile.  l sums the unrounded fp32 p; O is rescaled only when a
// row's max moved (late in a row it rarely does, and the multiplies by 1
// are not free).
template <typename T, int D, int QR, typename Vis>
__device__ __forceinline__ void fwd_step(FwdState<D>& st, const hopper::Frag& fr, uint32_t q_addr,
                                         uint32_t k_addr, uint32_t v_addr, float scale, bool masked,
                                         const Vis& vis) {
    using B = Boxes<D>;
    float sc[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B::KSTEPS; ++kk)
        hopper::mma_ss<T, BK>(sc, hopper::tile_desc<B::ROWB>(q_addr + hopper::kstep<QR, B::ROWB>(kk)),
                              hopper::tile_desc<B::ROWB>(k_addr + hopper::kstep<BK, B::ROWB>(kk)), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(sc);

    float mx[2] = {-INFINITY, -INFINITY};
    if (masked)
        scale_scores<true>(sc, mx, scale, fr, vis);
    else
        scale_scores<false>(sc, mx, scale, fr, vis);
    float ms2[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(st.m[r], hopper::quad_max(mx[r]));
        // a row with no visible key yet keeps m = -inf: guard the
        // subtraction so its p and alpha come out 0, not nan
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = hopper::ex2((st.m[r] - m_safe) * hopper::LOG2E);
        ms2[r] = m_safe * hopper::LOG2E;
        st.m[r] = m_new;
        st.l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1;
        const float pe = hopper::ex2(fmaf(sc[e], hopper::LOG2E, -ms2[r]));
        st.l[r] += pe;
        sc[e] = pe;
    }
    uint32_t pa[BK / 16][4];
    hopper::to_operand<T, BK>(sc, pa);
    // once a row's max settles, alpha is 1: skip the rescale
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int hf = 0; hf < B::HALVES; ++hf)
#pragma unroll
            for (int e = 0; e < B::COLS / 2; ++e) st.o[hf][e] *= alpha[(e >> 1) & 1];
    }
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) hopper::fence_regs(st.o[hf]);
    hopper::wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            hopper::mma_rs<T, B::COLS>(st.o[hf], pa[kk],
                                       hopper::tile_desc<B::ROWB>(v_addr + hf * BK * B::ROWB + kk * 16 * B::ROWB));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) hopper::fence_regs(st.o[hf]);
}

// The forward's epilogue: O = acc / l for rows row0 + fragment row below
// `limit`, columns below D (obase: the (b, h) slice, rows o_ss apart),
// and, where lse is given (the (b, h) row of [B, H, S]), lse = m + log(l).
// A row that saw no key keeps m = -inf and l = 0: O = 0, lse = -inf.
template <typename T, int D>
__device__ __forceinline__ void fwd_finish(const FwdState<D>& st, const hopper::Frag& fr, int t, T* obase,
                                           long long o_ss, int row0, int limit, float* lse) {
    using B = Boxes<D>;
    float lf[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lf[r] = fmaxf(hopper::quad_sum(st.l[r]), 1e-30f);
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf)
        hopper::store_frag<T, B::COLS>(st.o[hf], obase, o_ss, row0, hf * 64, limit, 1.f / lf[0], 1.f / lf[1], fr,
                                       D - hf * 64);
    if (lse != nullptr && (t & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qi = row0 + fr.row + 8 * r;
            if (qi < limit) lse[qi] = st.m[r] + logf(lf[r]);
        }
    }
}

// dK and dV accumulators of a warpgroup's 64 keys
template <int D>
struct DkvAcc {
    float dk[Boxes<D>::HALVES][Boxes<D>::COLS / 2];
    float dv[Boxes<D>::HALVES][Boxes<D>::COLS / 2];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int hf = 0; hf < Boxes<D>::HALVES; ++hf)
#pragma unroll
            for (int e = 0; e < Boxes<D>::COLS / 2; ++e) dk[hf][e] = dv[hf][e] = 0.f;
    }
};

// The A operands of dK/dV's two products from S^T and dP^T (st, dpt):
// pa = round_T(P^T), P^T = exp(S^T * scale - lse), 0 where vis says no
// (MASKED; a select, never -inf arithmetic: rows with no key have
// lse = -inf), and dsa = round_T(dS^T) from the unrounded P^T.  Eight
// columns at a time, packed as they are made, to keep the fp32 values'
// lives short (the dK/dV kernels run at their register cap).
template <typename T, int BQ, bool MASKED, typename Vis>
__device__ __forceinline__ void dkv_operands(const float (&st)[BQ / 2], const float (&dpt)[BQ / 2],
                                             uint32_t (&pa)[BQ / 16][4], uint32_t (&dsa)[BQ / 16][4],
                                             const float* lse_s, const float* delta_s, float scale2,
                                             float scale, const hopper::Frag& fr, const Vis& vis) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
        float p8[8], d8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int e = 8 * kk + j;
            const int c = 8 * (e / 4) + fr.col + (e & 1);     // query column c of the tile
            p8[j] = !MASKED || vis((e >> 1) & 1, c) ? hopper::ex2(fmaf(st[e], scale2, -lse_s[c])) : 0.f;
            d8[j] = p8[j] * (dpt[e] - delta_s[c]) * scale;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            pa[kk][i] = hopper::pack2<T>(p8[2 * i], p8[2 * i + 1]);
            dsa[kk][i] = hopper::pack2<T>(d8[2 * i], d8[2 * i + 1]);
        }
    }
}

// One q-tile of BQ queries of dK/dV, keys as the 64 M rows (JAX
// flash_attention.py :352-368 transposed):
//   S^T = K.Q^T and dP^T = V.dO^T     (wgmma, both operands K-major; k_addr
//                                      and v_addr hold this warpgroup's 64
//                                      rows of KR-row K and V tiles)
//   P^T = exp(S^T * scale - lse)      (lse_s: the q-tile's lse times log2 e;
//                                      masked by a select, never -inf
//                                      arithmetic: rows with no key have
//                                      lse = -inf)
//   dV += round_T(P^T).dO             (wgmma, A from registers, dO MN-major)
//   dS^T = round_T(P^T (dP^T - delta) scale), from the unrounded P^T
//   dK += dS^T.Q                      (wgmma, A from registers, Q MN-major)
// with fp32 accumulators.
template <typename T, int D, int KR, int BQ, typename Vis>
__device__ __forceinline__ void dkv_step(DkvAcc<D>& acc, const hopper::Frag& fr, uint32_t k_addr,
                                         uint32_t v_addr, uint32_t q_addr, uint32_t do_addr,
                                         const float* lse_s, const float* delta_s, float scale, bool masked,
                                         const Vis& vis) {
    using B = Boxes<D>;
    const float scale2 = scale * hopper::LOG2E;
    float st[BQ / 2], dpt[BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B::KSTEPS; ++kk)
        hopper::mma_ss<T, BQ>(st, hopper::tile_desc<B::ROWB>(k_addr + hopper::kstep<KR, B::ROWB>(kk)),
                              hopper::tile_desc<B::ROWB>(q_addr + hopper::kstep<BQ, B::ROWB>(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < B::KSTEPS; ++kk)
        hopper::mma_ss<T, BQ>(dpt, hopper::tile_desc<B::ROWB>(v_addr + hopper::kstep<KR, B::ROWB>(kk)),
                              hopper::tile_desc<B::ROWB>(do_addr + hopper::kstep<BQ, B::ROWB>(kk)), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    if (masked)
        dkv_operands<T, BQ, true>(st, dpt, pa, dsa, lse_s, delta_s, scale2, scale, fr, vis);
    else
        dkv_operands<T, BQ, false>(st, dpt, pa, dsa, lse_s, delta_s, scale2, scale, fr, vis);
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) {
        hopper::fence_regs(acc.dv[hf]);
        hopper::fence_regs(acc.dk[hf]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            hopper::mma_rs<T, B::COLS>(acc.dv[hf], pa[kk],
                                       hopper::tile_desc<B::ROWB>(do_addr + hf * BQ * B::ROWB + kk * 16 * B::ROWB));
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            hopper::mma_rs<T, B::COLS>(acc.dk[hf], dsa[kk],
                                       hopper::tile_desc<B::ROWB>(q_addr + hf * BQ * B::ROWB + kk * 16 * B::ROWB));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) {
        hopper::fence_regs(acc.dv[hf]);
        hopper::fence_regs(acc.dk[hf]);
    }
}

// Store a warpgroup's dK and dV (rows row0 + fragment row below `limit`,
// columns below D)
template <typename T, int D>
__device__ __forceinline__ void dkv_finish(const DkvAcc<D>& acc, const hopper::Frag& fr, T* dkp, long long dk_ss,
                                           T* dvp, long long dv_ss, int row0, int limit) {
    using B = Boxes<D>;
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) {
        hopper::store_frag<T, B::COLS>(acc.dk[hf], dkp, dk_ss, row0, hf * 64, limit, 1.f, 1.f, fr, D - hf * 64);
        hopper::store_frag<T, B::COLS>(acc.dv[hf], dvp, dv_ss, row0, hf * 64, limit, 1.f, 1.f, fr, D - hf * 64);
    }
}

// dQ accumulator of a warpgroup's 64 query rows
template <int D>
struct DqAcc {
    float dq[Boxes<D>::HALVES][Boxes<D>::COLS / 2];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int hf = 0; hf < Boxes<D>::HALVES; ++hf)
#pragma unroll
            for (int e = 0; e < Boxes<D>::COLS / 2; ++e) dq[hf][e] = 0.f;
    }
};

// The A operand of dQ's product from S and dP (sc, dp) of one k-tile:
// dsa = round_T(P (dP - delta) scale), P = exp(S * scale - lse), 0 where
// vis says no (MASKED; a select, never -inf arithmetic: a row with no
// live key has lse = -inf and its exponential is inf), from the unrounded
// P.  lse2 and dlt: the thread's two rows' lse times log2 e and delta.
// Eight columns at a time, packed as they are made, as dkv_operands does.
template <typename T, bool MASKED, typename Vis>
__device__ __forceinline__ void dq_operands(const float (&sc)[BK / 2], const float (&dp)[BK / 2],
                                            uint32_t (&dsa)[BK / 16][4], const float (&lse2)[2],
                                            const float (&dlt)[2], float scale2, float scale,
                                            const hopper::Frag& fr, const Vis& vis) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        float d8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int e = 8 * kk + j;
            const int r = (e >> 1) & 1;
            float pe = hopper::ex2(fmaf(sc[e], scale2, -lse2[r]));
            if (MASKED) pe = vis(r, 8 * (e / 4) + fr.col + (e & 1)) ? pe : 0.f;
            d8[j] = pe * (dp[e] - dlt[r]) * scale;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) dsa[kk][i] = hopper::pack2<T>(d8[2 * i], d8[2 * i + 1]);
    }
}

// One k-tile of 64 keys of dQ, queries as the 64 M rows (JAX
// flash_attention.py :246-301):
//   S = Q.K^T and dP = dO.V^T     (wgmma, both operands K-major; q_addr and
//                                  do_addr hold this warpgroup's 64 rows of
//                                  QR-row Q and dO tiles, k_addr and v_addr
//                                  the 64-key K and V tiles)
//   P = exp(S * scale - lse)      (a select where masked, dq_operands)
//   dS = round_T(P (dP - delta) scale), from the unrounded P (JAX :286)
//   dQ += dS.K                    (wgmma, dS from registers, the same K tile
//                                  read MN-major; at D 128 two N = 64
//                                  products over K's two 64-column boxes)
// with fp32 accumulators.
template <typename T, int D, int QR, typename Vis>
__device__ __forceinline__ void dq_step(DqAcc<D>& acc, const hopper::Frag& fr, uint32_t q_addr, uint32_t do_addr,
                                        uint32_t k_addr, uint32_t v_addr, const float (&lse2)[2],
                                        const float (&dlt)[2], float scale, bool masked, const Vis& vis) {
    using B = Boxes<D>;
    float sc[BK / 2], dp[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B::KSTEPS; ++kk)
        hopper::mma_ss<T, BK>(sc, hopper::tile_desc<B::ROWB>(q_addr + hopper::kstep<QR, B::ROWB>(kk)),
                              hopper::tile_desc<B::ROWB>(k_addr + hopper::kstep<BK, B::ROWB>(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < B::KSTEPS; ++kk)
        hopper::mma_ss<T, BK>(dp, hopper::tile_desc<B::ROWB>(do_addr + hopper::kstep<QR, B::ROWB>(kk)),
                              hopper::tile_desc<B::ROWB>(v_addr + hopper::kstep<BK, B::ROWB>(kk)), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const float scale2 = scale * hopper::LOG2E;
    uint32_t dsa[BK / 16][4];
    if (masked)
        dq_operands<T, true>(sc, dp, dsa, lse2, dlt, scale2, scale, fr, vis);
    else
        dq_operands<T, false>(sc, dp, dsa, lse2, dlt, scale2, scale, fr, vis);
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) hopper::fence_regs(acc.dq[hf]);
    hopper::wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            hopper::mma_rs<T, B::COLS>(acc.dq[hf], dsa[kk],
                                       hopper::tile_desc<B::ROWB>(k_addr + hf * BK * B::ROWB + kk * 16 * B::ROWB));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf) hopper::fence_regs(acc.dq[hf]);
}

// Store a warpgroup's dQ (rows row0 + fragment row below `limit`, columns
// below D)
template <typename T, int D>
__device__ __forceinline__ void dq_finish(const DqAcc<D>& acc, const hopper::Frag& fr, T* dqp, long long dq_ss,
                                          int row0, int limit) {
    using B = Boxes<D>;
#pragma unroll
    for (int hf = 0; hf < B::HALVES; ++hf)
        hopper::store_frag<T, B::COLS>(acc.dq[hf], dqp, dq_ss, row0, hf * 64, limit, 1.f, 1.f, fr, D - hf * 64);
}

}  // namespace attn_tc
