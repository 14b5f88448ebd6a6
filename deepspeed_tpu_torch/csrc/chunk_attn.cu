// chunk_attn: a chunk of Sq queries over the padded KV cache.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// _chunk_kernel (line 218): query i of row b sits at absolute position
// pos[b] + i (pos scalar or per row) and sees cache slots <= pos[b] + i;
// fp32 scores, running max floored at M_FLOOR, p kept in fp32, O = acc / l.
// chunk_attn_int8 is the kernel's int8-cache option (:258-260): int8 codes
// with one fp32 scale per head vector.  The kernel's two other options, in
// both entry points and on both paths: window (:238-244, :265-266; 0 for
// none) bands query i to keys (pos[b] + i - window, pos[b] + i], and slopes
// ([H] fp32, :262-263; nullptr for none) adds ALiBi's
// -slopes[h] * (pos[b] + i - j) to the scaled fp32 score, before the row
// max.  A unit's live k-tiles then start at the tile of its first row's
// band start, not at 0 (JAX clamps its DMA into [band start, frontier],
// :319-325), the cluster splits that range, and a tile that crosses the
// band's lower edge for some row is masked.
//
// Bound on the H100: a chunk of Sq queries does 4*D FLOPs per visible
// pair against 4*D bytes per live bf16 cache row (2*D + 8 for int8), about
// Sq FLOPs per byte: below the card's 295 bf16 FLOPs per byte for the
// slice's 128-token chunks, so the least time is the live-prefix bytes
// over 3.35 TB/s, about a microsecond at the serving shape.  What holds a
// kernel back there is latency: 32 (b, h, 64-query) units for 132 SMs, and
// a walk along the keys one k-tile after another.
//
// bf16 and fp16 (chunk_attn_tc, also over the int8 cache): the Hopper
// design.  A unit is (b, h, 64-query tile), launched as a thread-block
// cluster of n CTAs (n a power of two <= 8: the largest whose CTAs fit
// one wave of SMs, and no more than the live k-tiles).  CTA r takes a
// contiguous share of the unit's live k-tiles (at or below pos + q0 + 63)
// and runs the online softmax over them: one consumer warpgroup, and a
// producer warp that loads Q once with TMA and streams K and V through a
// ring of mbarrier-guarded stages (over the int8 cache, a producer
// warpgroup: below).  S = Q.K^T on wgmma from the unscaled
// 16-bit q and K (exact products, fp32 sums), times scale on the fp32
// fragment; P.V as two wgmma products, hi = round_T(P) and
// lo = round_T(P - hi), so p keeps about 16 mantissa bits, not 8.  Each
// CTA stages its fp32 (m, l) per row and acc[64, D] in its own shared
// memory (over the ring); after a cluster barrier CTA r combines its slice
// of the rows from the n partials in rank order through distributed
// shared memory, m = max m_i, O = sum acc_i e^(m_i - m) / sum l_i
// e^(m_i - m), and writes O; a second barrier keeps every CTA resident
// until its peers have read it.  A CTA with an empty share keeps
// m = M_FLOOR, l = 0, acc = 0.  Fixed order, no atomics: bitwise
// repeatable.
//
// int8 cache: TMA brings each k-tile's codes ([64, D] bytes of K and of V,
// unswizzled: HBM still moves int8 bytes) into a raw stage of their own,
// up to STAGES tiles ahead.  The producer is a whole warpgroup here: its
// threads widen the codes to T (exact: |code| <= 127, on integer and add
// units) from shared memory into the swizzled layout the wgmma descriptors
// read, and put k_scale * scale and v_scale (plain loads, a tile ahead)
// beside them.  Reading the codes into registers with 16-byte loads cost
// 254 registers a thread and a load round trip per tile on the producer's
// path, and one producer warp's conversion set the pace: both were slower.
// The consumer multiplies column j of S by k_scale[j] * scale and folds
// v_scale[j] into column j of P before the hi/lo split
// (sum p (code vs) = sum (p vs) code).
//
// fp32 keeps the FMA kernel of flash_tile.cuh (wgmma reads V transposed,
// which it does for 16-bit operands only).
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tiles of
// 128 (common.cuh tile_dim): S = Q.K^T stops at D's last 16-column step;
// P.V computes the padded columns (zeros TMA fills in, or over the int8
// cache whatever the ring held: the widening writes D's columns only) and
// they are neither staged nor stored.
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int CH_BQ = 64;          // query rows per unit: one warpgroup
constexpr int CH_BK = 64;          // keys per k-tile
constexpr int CH_MAX_CLUSTER = 8;  // the portable cluster size

struct ChunkParams {
    CUtensorMap q;                 // rows of 64 per box
    CUtensorMap k, v;              // rows of 64 per box: 16-bit tiles, or int8 codes
    void* o;
    const float* k_scale; const float* v_scale;  // int8 cache: the codes' scales
    const int* pos;
    int pos_scalar;
    int Sq, Smax, H, cluster;
    int window;                    // band width, 0: none
    const float* slopes;           // ALiBi [H], nullptr: none
    long long o_sb, o_ss, o_sh;
    long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
    float scale;
};

template <int D, bool Q8>
struct ChunkCfg {
    static constexpr int DT = HeadDim<D>::TILE;             // D 80, 96: D 128's boxes
    static constexpr int HALVES = DT > 64 ? DT / 64 : 1;   // boxes per row
    static constexpr int COLS = DT < 64 ? DT : 64;          // columns per box
    static_assert(HALVES * COLS == DT && D > (HALVES - 1) * COLS, "each box holds a column of D");
    static constexpr int ROWB = 2 * COLS;                   // bytes per box row
    static constexpr int STAGES = D > 64 ? 2 : 3;
    // the producer: a warp that issues TMA loads, or with an int8 cache a
    // warpgroup that also widens the codes
    static constexpr int PRODUCERS = Q8 ? 128 : 32;
    static constexpr int THREADS = 128 + PRODUCERS;         // after the consumer warpgroup
    static constexpr int TILE_BYTES = HALVES * 64 * ROWB;   // one of Q, K, V
    static constexpr int RING_OFF = TILE_BYTES;             // stage s: K, then V
    static constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;
    static constexpr int ACC_LD = D + 4;                    // staged acc row, padded
    // the combine's staging over the ring: m, l [64], acc [64][ACC_LD] fp32
    static constexpr int STAGING = (2 * 64 + 64 * ACC_LD) * 4;
    static_assert(STAGING <= RING_BYTES, "the staging reuses the ring");
    // int8: stage s of the codes as TMA lands them (K, then V: [64][D]
    // bytes each), and of the scales (k_scale * scale, then v_scale)
    static constexpr int CODE_BYTES = CH_BK * D;
    static constexpr int RAW_OFF = RING_OFF + RING_BYTES;
    static constexpr int SCALE_OFF = RAW_OFF + (Q8 ? STAGES * 2 * CODE_BYTES : 0);
    static constexpr int BAR_OFF = SCALE_OFF + (Q8 ? STAGES * 2 * CH_BK * 4 : 0);
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;   // + alignment slack
};

// Four int8 codes (one word, lowest address first) as two packed pairs of
// T, exactly, on integer and add units instead of the quarter-rate
// int-to-float converter.  Each code c, biased to the byte c + 128, becomes
// the low mantissa bits of a half 1024 + (c + 128), or of a float
// 2^23 + (c + 128) whose top 16 bits are the bf16 of c once the bias is
// subtracted (c is exact in 8 bits of mantissa).
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& p01, uint32_t& p23, __half) {
    const uint32_t u = x ^ 0x80808080u;
    uint32_t h[2] = {__byte_perm(u, 0x64646464u, 0x5140), __byte_perm(u, 0x64646464u, 0x7362)};
    __half2* v = reinterpret_cast<__half2*>(h);
    const __half2 bias = __half2half2(__ushort_as_half(0x6480));   // 1152
    v[0] = __hsub2(v[0], bias);
    v[1] = __hsub2(v[1], bias);
    p01 = h[0];
    p23 = h[1];
}
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& p01, uint32_t& p23, __nv_bfloat16) {
    const uint32_t u = x ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        f[k] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | k)) - 8388736.f);
    p01 = __byte_perm(f[0], f[1], 0x7632);
    p23 = __byte_perm(f[2], f[3], 0x7632);
}

// One [64][D] tile of int8 codes (row after row) widened to T, exactly,
// into the swizzled box layout the wgmma descriptors read, by the producer
// threads, with 16-byte reads and writes.
template <typename T, int D>
__device__ __forceinline__ void widen_tile(uint8_t* tile, const uint8_t* codes, int lane) {
    using C = ChunkCfg<D, true>;
    constexpr int VPR = D / 16;                   // 16-byte code vectors per row
    static_assert(VPR * 16 == D, "whole 16-byte code vectors a row");
#pragma unroll 4
    for (int id = lane; id < CH_BK * VPR; id += C::PRODUCERS) {
        const int j = id / VPR, vv = id % VPR;
        const uint4 r = *reinterpret_cast<const uint4*>(codes + j * D + vv * 16);
        uint32_t w[8];
        widen4(r.x, w[0], w[1], T());
        widen4(r.y, w[2], w[3], T());
        widen4(r.z, w[4], w[5], T());
        widen4(r.w, w[6], w[7], T());
        const int col = vv * 16;                  // 16 columns: two 16-byte chunks of T
        uint8_t* box = tile + (col / C::COLS) * 64 * C::ROWB;
        const int ch = (col % C::COLS) / 8;
        *reinterpret_cast<uint4*>(box + hopper::swizzled<C::ROWB>(j, ch)) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(box + hopper::swizzled<C::ROWB>(j, ch + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
    }
}

template <typename T, int D, bool Q8>
__global__ void __launch_bounds__(ChunkCfg<D, Q8>::THREADS, 1) chunk_attn_tc(const __grid_constant__ ChunkParams p) {
    using C = ChunkCfg<D, Q8>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;
    uint8_t* ring = smem + C::RING_OFF;
    uint8_t* raw = smem + C::RAW_OFF;
    float* scl = reinterpret_cast<float*>(smem + C::SCALE_OFF);
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + C::STAGES;
    uint64_t* landed = empty + C::STAGES;         // int8: a stage's codes are in
    float* m_s = reinterpret_cast<float*>(ring);  // the combine's staging
    float* l_s = m_s + 64;
    float* acc_s = l_s + 64;

    const int n = p.cluster;
    const int rank = static_cast<int>(hopper::cluster_rank());
    const int nqt = gridDim.x / n;
    const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x) / n) * CH_BQ;   // most keys first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int pos = p.pos != nullptr ? p.pos[b] : p.pos_scalar;
    const int kend = max(0, min(p.Smax, pos + min(p.Sq, q0 + CH_BQ)));
    const int ntiles = (kend + CH_BK - 1) / CH_BK;
    // the live k-tiles [first, ntiles): from the tile of the first row's
    // band start (0 without a window) to the last row's frontier
    const int win = p.window > 0 ? p.window : INT_MAX;
    const int first = p.window > 0 ? min(ntiles, max(0, pos + q0 - win + 1) / CH_BK) : 0;
    const int live = ntiles - first;
    const int lo = first + live * rank / n;       // this CTA's share of the k-tiles
    const int mine = first + live * (rank + 1) / n - lo;

    if (threadIdx.x == 0) {
        hopper::mbar_init(q_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], Q8 ? C::PRODUCERS : 1);   // int8: every producer thread writes
            hopper::mbar_init(&empty[s], 4);            // one arrival per consumer warp
            hopper::mbar_init(&landed[s], 1);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // producer
        const int lane = threadIdx.x - 128;
        if (mine > 0 && lane == 0) {
            hopper::mbar_expect_tx(q_bar, C::TILE_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf)
                hopper::tma_load_4d(qs + hf * 64 * C::ROWB, &p.q, q_bar, hf * 64, h, q0, b);
        }
        if constexpr (Q8) {
            // TMA brings each k-tile's codes into its raw stage, STAGES
            // tiles ahead; the producer threads widen them into the ring
            // and copy the scales (fetched a tile ahead) beside them
            auto load_codes = [&](int i) {
                const int s = i % C::STAGES;
                uint8_t* dst = raw + s * 2 * C::CODE_BYTES;
                hopper::mbar_expect_tx(&landed[s], 2 * C::CODE_BYTES);
                hopper::tma_load_4d(dst, &p.k, &landed[s], 0, h, (lo + i) * CH_BK, b);
                hopper::tma_load_4d(dst + C::CODE_BYTES, &p.v, &landed[s], 0, h, (lo + i) * CH_BK, b);
            };
            if (lane == 0)
                for (int i = 0; i < min(C::STAGES, mine); ++i) load_codes(i);
            const float* ksb = p.k_scale + b * p.ks_sb + h * p.ks_sh;
            const float* vsb = p.v_scale + b * p.vs_sb + h * p.vs_sh;
            // scale r of a stage: k_scale * scale of row r (r < 64), then
            // v_scale of row r - 64
            constexpr int NS = 2 * CH_BK / C::PRODUCERS;
            float sn[NS];
            auto fetch = [&](int i) {
#pragma unroll
                for (int u = 0; u < NS; ++u) {
                    const int r = lane + C::PRODUCERS * u;
                    const int row = (lo + i) * CH_BK + r % CH_BK;
                    sn[u] = row >= p.Smax ? 0.f
                            : r < CH_BK ? ksb[(long long)row * p.ks_ss] * p.scale
                                        : vsb[(long long)row * p.vs_ss];
                }
            };
            if (mine > 0) fetch(0);
            for (int i = 0; i < mine; ++i) {
                const int s = i % C::STAGES;
                const uint32_t ph = (i / C::STAGES) & 1;
                hopper::mbar_wait(&empty[s], ph ^ 1);
                float* st = scl + s * 2 * CH_BK;
#pragma unroll
                for (int u = 0; u < NS; ++u) st[lane + C::PRODUCERS * u] = sn[u];
                if (i + 1 < mine) fetch(i + 1);
                hopper::mbar_wait(&landed[s], ph);
                uint8_t* ks = ring + s * 2 * C::TILE_BYTES;
                const uint8_t* codes = raw + s * 2 * C::CODE_BYTES;
                widen_tile<T, D>(ks, codes, lane);
                widen_tile<T, D>(ks + C::TILE_BYTES, codes + C::CODE_BYTES, lane);
                // the widened tiles for wgmma, and the raw stage's reads
                // before TMA refills it
                hopper::fence_proxy_async();
                hopper::mbar_arrive(&full[s]);
                hopper::named_sync(2, C::PRODUCERS);
                if (lane == 0 && i + C::STAGES < mine) load_codes(i + C::STAGES);
            }
        } else if (lane == 0) {
            for (int i = 0; i < mine; ++i) {
                const int s = i % C::STAGES;
                const int k0 = (lo + i) * CH_BK;
                hopper::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], 2 * C::TILE_BYTES);
                uint8_t* ks = ring + s * 2 * C::TILE_BYTES;
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(ks + hf * 64 * C::ROWB, &p.k, &full[s], hf * 64, h, k0, b);
                    hopper::tma_load_4d(ks + C::TILE_BYTES + hf * 64 * C::ROWB, &p.v, &full[s], hf * 64, h, k0, b);
                }
            }
        }
    } else {
        // consumer warpgroup: the online softmax over this CTA's share
        const int t = threadIdx.x;
        const hopper::Frag fr(t);
        const int qp[2] = {pos + q0 + fr.row, pos + q0 + fr.row + 8};   // last visible slot of each row
        float o[C::HALVES][C::COLS / 2];
#pragma unroll
        for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
            for (int e = 0; e < C::COLS / 2; ++e) o[hf][e] = 0.f;
        float m[2] = {DS_M_FLOOR, DS_M_FLOOR};    // running max of the scaled scores
        float l[2] = {0.f, 0.f};                  // this thread's share of the row sums
        const uint32_t q_addr = hopper::smem_u32(qs);
        const bool alibi = p.slopes != nullptr;
        const float slope = alibi ? p.slopes[h] : 0.f;

        if (mine > 0) hopper::mbar_wait(q_bar, 0);
        for (int i = 0; i < mine; ++i) {
            const int s = i % C::STAGES;
            const int k0 = (lo + i) * CH_BK;
            hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
            const uint32_t k_addr = hopper::smem_u32(ring + s * 2 * C::TILE_BYTES);
            const uint32_t v_addr = k_addr + C::TILE_BYTES;
            const float* ksc = scl + s * 2 * CH_BK;   // int8: k_scale * scale, then v_scale
            const float* vsc = ksc + CH_BK;

            float sc[CH_BK / 2];
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)   // D's columns only
                hopper::mma_ss<T, CH_BK>(sc, hopper::tile_desc<C::ROWB>(q_addr + hopper::kstep<CH_BQ, C::ROWB>(kk)),
                                         hopper::tile_desc<C::ROWB>(k_addr + hopper::kstep<CH_BK, C::ROWB>(kk)), kk > 0);
            hopper::wgmma_commit();
            hopper::wgmma_wait0();
            hopper::fence_regs(sc);

            // only a tile past the first row's frontier, past the cache's
            // end, or below the last row's band start is masked
            const bool crosses = k0 + CH_BK - 1 > pos + q0 || k0 + CH_BK > p.Smax ||
                                 pos + q0 + CH_BQ - 1 - k0 >= win;
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int e = 0; e < CH_BK / 2; ++e) {
                const int c = 8 * (e / 4) + fr.col + (e & 1);
                const int r = (e >> 1) & 1;
                float x = sc[e] * (Q8 ? ksc[c] : p.scale);
                if (alibi) x = fmaf(-slope, static_cast<float>(qp[r] - (k0 + c)), x);
                if (crosses) {
                    const int kj = k0 + c;
                    x = kj < p.Smax && kj <= qp[r] && qp[r] - kj < win ? x : -INFINITY;
                }
                sc[e] = x;
                mx[r] = fmaxf(mx[r], x);
            }
            float ms2[2], alpha[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                // m stays at or above M_FLOOR, so masked scores give p = 0
                const float m_new = fmaxf(m[r], hopper::quad_max(mx[r]));
                alpha[r] = hopper::ex2((m[r] - m_new) * hopper::LOG2E);
                ms2[r] = m_new * hopper::LOG2E;
                m[r] = m_new;
                l[r] *= alpha[r];
            }
#pragma unroll
            for (int e = 0; e < CH_BK / 2; ++e) {
                const int r = (e >> 1) & 1;
                float pe = hopper::ex2(fmaf(sc[e], hopper::LOG2E, -ms2[r]));
                l[r] += pe;
                if (Q8) pe *= vsc[8 * (e / 4) + fr.col + (e & 1)];
                sc[e] = pe;
            }
            // P = hi + lo in two 16-bit operands: about 16 bits of the fp32 p
            uint32_t ph[CH_BK / 16][4], pl[CH_BK / 16][4];
            hopper::to_operand<T, CH_BK>(sc, ph);
#pragma unroll
            for (int e = 0; e < CH_BK / 2; ++e) sc[e] -= round_to<T>(sc[e]);
            hopper::to_operand<T, CH_BK>(sc, pl);
            if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
                for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
                    for (int e = 0; e < C::COLS / 2; ++e) o[hf][e] *= alpha[(e >> 1) & 1];
            }
#pragma unroll
            for (int hf = 0; hf < C::HALVES; ++hf) hopper::fence_regs(o[hf]);
            hopper::wgmma_fence();
#pragma unroll
            for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
                for (int kk = 0; kk < CH_BK / 16; ++kk) {
                    const uint64_t vd = hopper::tile_desc<C::ROWB>(v_addr + hf * 64 * C::ROWB + kk * 16 * C::ROWB);
                    hopper::mma_rs<T, C::COLS>(o[hf], ph[kk], vd);
                    hopper::mma_rs<T, C::COLS>(o[hf], pl[kk], vd);
                }
            hopper::wgmma_commit();
            hopper::wgmma_wait0();
#pragma unroll
            for (int hf = 0; hf < C::HALVES; ++hf) hopper::fence_regs(o[hf]);
            if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
        }

        // stage the partial (m, l, acc) over the ring, once every warp's
        // products have read their last tile
        hopper::named_sync(1, 128);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float lr = hopper::quad_sum(l[r]);
            if ((t & 3) == 0) {
                m_s[fr.row + 8 * r] = m[r];
                l_s[fr.row + 8 * r] = lr;
            }
        }
#pragma unroll
        for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
            for (int j = 0; j < C::COLS / 8; ++j) {
                if (hf * 64 + 8 * j >= D) continue;     // the padded columns stay out
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    *reinterpret_cast<float2*>(acc_s + (fr.row + 8 * r) * C::ACC_LD + hf * 64 + 8 * j + fr.col) =
                        make_float2(o[hf][4 * j + 2 * r], o[hf][4 * j + 2 * r + 1]);
            }
    }

    hopper::cluster_sync();                       // every partial is staged
    // CTA `rank` combines rows r0 .. r0 + 64/n - 1 from the n partials, in
    // rank order
    const int rows = CH_BQ / n;
    const int r0 = rank * rows;
    T* obase = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
    for (int id = threadIdx.x; id < rows * (D / 4); id += C::THREADS) {
        const int row = r0 + id / (D / 4);
        const int c4 = id % (D / 4);
        if (q0 + row >= p.Sq) continue;
        float mi[CH_MAX_CLUSTER];
        float mx = DS_M_FLOOR;
#pragma unroll
        for (int j = 0; j < CH_MAX_CLUSTER; ++j)
            if (j < n) {
                mi[j] = hopper::ld_cluster(hopper::cluster_map(m_s + row, j));
                mx = fmaxf(mx, mi[j]);
            }
        float lsum = 0.f;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < CH_MAX_CLUSTER; ++j)
            if (j < n) {
                const float w = hopper::ex2((mi[j] - mx) * hopper::LOG2E);
                lsum += hopper::ld_cluster(hopper::cluster_map(l_s + row, j)) * w;
                const float4 a = hopper::ld_cluster4(hopper::cluster_map(acc_s + row * C::ACC_LD + 4 * c4, j));
                acc.x += a.x * w; acc.y += a.y * w; acc.z += a.z * w; acc.w += a.w * w;
            }
        const float inv = 1.f / fmaxf(lsum, 1e-30f);
        store_vec4<T>(obase + (long long)(q0 + row) * p.o_ss + 4 * c4,
                      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    }
    hopper::cluster_sync();                       // the peers are done reading this CTA
}

template <typename T, int D, bool Q8>
cudaError_t launch_chunk_tc(const ChunkParams& p, int B, cudaStream_t stream) {
    using C = ChunkCfg<D, Q8>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(chunk_attn_tc<T, D, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((p.Sq + CH_BQ - 1) / CH_BQ * p.cluster, p.H, B);
    cfg.blockDim = dim3(C::THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = p.cluster;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    void* args[] = {const_cast<ChunkParams*>(&p)};
    const cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(chunk_attn_tc<T, D, Q8>), args);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// The shared half of the two entry points' tensor-core path: the maps of
// Q, and of K and V (16-bit tiles, or int8 codes), the cluster size, the
// launch.
template <bool Q8>
cudaError_t run_chunk_tc(ChunkParams& p, const void* q, const void* k, const void* v, int dtype, int B, int D,
                         long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss, long long v_sh, cudaStream_t stream) {
    cudaError_t err = hopper::map_rows(&p.q, q, dtype, B, p.Sq, p.H, D, q_sb, q_ss, q_sh, CH_BQ);
    // an empty cache loads nothing (the maps stay empty): O = 0
    const int kv_type = Q8 ? hopper::kCodes : dtype;
    if (p.Smax > 0 && err == cudaSuccess)
        err = hopper::map_rows(&p.k, k, kv_type, B, p.Smax, p.H, D, k_sb, k_ss, k_sh, CH_BK);
    if (p.Smax > 0 && err == cudaSuccess)
        err = hopper::map_rows(&p.v, v, kv_type, B, p.Smax, p.H, D, v_sb, v_ss, v_sh, CH_BK);
    if (err != cudaSuccess) return err;
    // the largest power of two <= 8 whose CTAs fit one wave of SMs, and no
    // more ranks than the live k-tiles of the longest unit (with a window,
    // no more than a 64-row unit's band spans)
    const int units = B * p.H * ((p.Sq + CH_BQ - 1) / CH_BQ);
    int live = p.pos != nullptr ? p.Smax : min(p.Smax, p.pos_scalar + p.Sq);
    if (p.window > 0) live = min(live, p.window + CH_BQ + CH_BK - 1);
    const int tiles = (live + CH_BK - 1) / CH_BK;
    int n = 1;
    while (n < CH_MAX_CLUSTER && (long long)units * 2 * n <= sm_count() && 2 * n <= tiles) n *= 2;
    p.cluster = n;
#define DS_CHUNK_D(T)                                                     \
    switch (D) {                                                          \
        case 32: return launch_chunk_tc<T, 32, Q8>(p, B, stream);         \
        case 64: return launch_chunk_tc<T, 64, Q8>(p, B, stream);         \
        case 80: return launch_chunk_tc<T, 80, Q8>(p, B, stream);         \
        case 96: return launch_chunk_tc<T, 96, Q8>(p, B, stream);         \
        case 128: return launch_chunk_tc<T, 128, Q8>(p, B, stream);       \
        default: return cudaErrorInvalidValue;                            \
    }
    if (dtype == kBF16) DS_CHUNK_D(__nv_bfloat16)
    DS_CHUNK_D(__half)
#undef DS_CHUNK_D
}

}  // namespace

extern "C" int chunk_attn(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int Sq, int Smax, int H, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          const int* pos, int pos_scalar, int window, const float* slopes, float scale,
                          void* stream) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == kF32) {
        TileArgs a{q, k, v, o, nullptr, B, Sq, Smax, H,
                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                   scale, 1, pos, pos_scalar};
        a.window = window;
        a.slopes = slopes;
        return static_cast<int>(dispatch_tile<true>(D, a, st));
    }
    if (dtype != kF16 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    ChunkParams p{};
    p.o = o; p.pos = pos; p.pos_scalar = pos_scalar;
    p.Sq = Sq; p.Smax = Smax; p.H = H;
    p.window = window; p.slopes = slopes;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.scale = scale;
    return static_cast<int>(run_chunk_tc<false>(p, q, k, v, dtype, B, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                                v_sb, v_ss, v_sh, st));
}

// k, v: int8 codes; k_scale, v_scale: fp32 [B, S_max, H, 1] through strides
extern "C" int chunk_attn_int8(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int Sq, int Smax, int H, int D,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long o_sb, long long o_ss, long long o_sh,
                               const float* k_scale, const float* v_scale,
                               long long ks_sb, long long ks_ss, long long ks_sh,
                               long long vs_sb, long long vs_ss, long long vs_sh,
                               const int* pos, int pos_scalar, int window, const float* slopes, float scale,
                               void* stream) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == kF32) {
        TileArgs a{q, k, v, o, nullptr, B, Sq, Smax, H,
                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                   scale, 1, pos, pos_scalar, nullptr, k_scale, v_scale,
                   ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
        a.window = window;
        a.slopes = slopes;
        return static_cast<int>(dispatch_tile<true, true>(D, a, st));
    }
    if (dtype != kF16 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    ChunkParams p{};
    p.o = o; p.pos = pos; p.pos_scalar = pos_scalar;
    p.k_scale = k_scale; p.v_scale = v_scale;
    p.Sq = Sq; p.Smax = Smax; p.H = H;
    p.window = window; p.slopes = slopes;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.ks_sb = ks_sb; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
    p.vs_sb = vs_sb; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
    p.scale = scale;
    return static_cast<int>(run_chunk_tc<true>(p, q, k, v, dtype, B, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                               v_sb, v_ss, v_sh, st));
}
