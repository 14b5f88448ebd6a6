// decode_attn: one query token per (b, h) over the padded KV cache.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// _decode_kernel (line 101): row b's query sees cache slots 0..pos[b]
// (pos scalar or per row); fp32 scores, running max floored at M_FLOOR.
// decode_attn_int8 is the kernel's int8-cache option (:135-137): K and V
// arrive as int8 codes with one fp32 scale per head vector ([B, S_max, H,
// 1], read through its own strides).  The kernel's two other options, in
// both entry points and every kernel below: window (:125-129, :139-140;
// 0 for none) bands row b's keys to [pos_b - window + 1, pos_b], and
// slopes ([H] fp32, :137-138; nullptr for none) adds ALiBi's
// -slopes[h] * (pos_b - j) to the scaled fp32 score of key j, before the
// row max.
//
// Bound on the H100: memory.  Each live cache row is read once (2*D
// elements of K and V, plus two fp32 scales for the int8 cache) for 4*D
// FLOPs, so the least time is the live-prefix K/V bytes over 3.35 TB/s;
// the int8 cache moves 0.53x the bf16 bytes at D = 64.  Below the bound,
// a CTA's rate is set by its consumer: on FMAs each key costs every lane
// of its row a widening, a product and a shuffle reduction (and int8 codes
// the quarter-rate int-to-float converter), and at the serving shape the
// longest rows' CTAs set the time.
//
// The design:
// - Keys move by TMA into a ring of shared-memory stages guarded by
//   mbarriers: a tile of KT keys of K and of V per stage, one box a column
//   box for a whole tile, boxes of DEC_SUB rows for a partial tile (a tile
//   loads its live rows' boxes only), and rank 0 loads its first box before
//   it reads pos.  Rows of the last box past the frontier are loaded but
//   never used: scores there are -inf by a select, and V rows are zeroed
//   (mma) or skipped (FMA), so non-finite values in stale slots cannot
//   reach the output.
// - bf16 and fp16 caches (decode_attn_mma): each warp takes 16 keys of a
//   tile and runs q . K^T and P . V on mma.sync (m16n8k16) with q as row 0
//   of the A operand and ldmatrix reads of the swizzled tiles: one mma a
//   key or so instead of a widening and a product per element, for a
//   1/16-used tile.  The online softmax runs on the fragment's row 0 (lanes
//   0-3) in log2 units, and P enters P . V as hi + lo (two 16-bit parts,
//   about 16 mantissa bits).  No wgmma: its 64-row operand would be 1/64
//   used.
// - fp32 caches, and int8 codes under any query type (decode_attn_fma):
//   G groups of TPK lanes (D / VEC up to a power of two), a group two
//   keys of each tile, one 16-byte
//   shared-memory read per lane per row, fp32 FMAs; int8 codes widen on
//   integer and add units, and the scales multiply a row's sum
//   (S_j = k_scale_j q . codes_j, acc += (p_j v_scale_j) codes_j), not each
//   element.  The groups merge by a fixed butterfly in each warp, the warps
//   in warp order.
// - The split: each (b, h) is a cluster of n CTAs over n contiguous
//   shares of its live keys, n the largest power of two <= 8 whose B * H * n
//   CTAs fit one wave at one CTA an SM, from S_max (or a scalar pos, or
//   the window where it is smaller) and the SM count on the host, never a
//   per-row pos.  The live keys start at the band's first key
//   max(0, pos_b - window + 1) (at 0 without a window), so share r is
//   [base + r span, base + (r + 1) span): keys below the band are never
//   loaded, nor scored, so no mask needs the band's lower edge, and a
//   banded row streams O(window) bytes, not O(pos_b).  At the 8-slot serving
//   batch with 16 heads that is n = 1 (128 CTAs); one request's 16 heads
//   spread over 8 CTAs each.  A share past its row's frontier is dead and
//   contributes m = M_FLOOR, l = 0, acc = 0; share 0 always holds key 0.
//   Each peer stores its partial into rank 0's shared memory (distributed
//   shared memory) and arrives on rank 0's mbarrier, then leaves; rank 0
//   combines the n partials in rank order, O = sum acc_r e^(m_r - m) /
//   sum l_r e^(m_r - m).  Fixed orders, no atomics: bitwise repeatable.
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M): the mma
// kernel's tiles take D 128's two 64-column boxes (common.cuh tile_dim;
// TMA zero-fills the columns past D and moves D's bytes from memory), its
// q . K^T stops at D's last 16-column step and P . V covers D's 8-column
// blocks only; the FMA kernel's rows stay D elements (D * sizeof(C) bytes,
// a multiple of 16) and a row takes the next power of two of D / VEC
// lanes, those past the row idle.
//
// Tried on the card and slower (PERF.md): per-row cp.async.bulk copies,
// per-thread cp.async, the FMA consumer for bf16, the mma consumer for
// int8 (its widening pass through shared memory), splitting the serving
// batch's rows over 2-8 CTAs each, a share's first box by plain loads.
#include "hopper.cuh"

namespace {

constexpr int DEC_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int DEC_RING = 96 * 1024; // bytes of the mma kernel's ring
constexpr int DEC_SUB = 16;         // rows of one TMA box: a tile loads its live boxes only

struct DecodeParams {
    CUtensorMap k, v;               // [KT, D] tiles of one (b, h) head slice of K and V
    CUtensorMap k_sub, v_sub;       // the same in boxes of DEC_SUB rows
    const void* q;
    void* o;
    const int* pos;
    int pos_scalar;
    int Smax, span;                 // span: keys per share, a multiple of KT
    int window;                     // band width, 0: none
    const float* slopes;            // ALiBi [H], nullptr: none
    long long q_sb, q_sh, o_sb, o_sh;
    // int8 cache only: per-vector scales [B, S_max, H, 1]
    const float* k_scale; const float* v_scale;
    long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
    float scale;
};

// the first key of row b's band: its keys are [band_start, pos_b]
__device__ __forceinline__ int band_start(const DecodeParams& p, int pos_b) {
    return p.window > 0 ? max(0, pos_b - p.window + 1) : 0;
}

// head h's ALiBi slope (0 without slopes: the bias vanishes exactly)
__device__ __forceinline__ float alibi_slope(const DecodeParams& p, int h) {
    return p.slopes != nullptr ? p.slopes[h] : 0.f;
}

// The end of every CTA: its partial (m, l, acc[D] of column tid) goes to
// rank 0, which combines the n partials in rank order and writes O.  m is
// in log2 units when LOG2 (scores scaled by log2 e), else natural ones.
template <typename T, int D, bool LOG2>
struct Combine {
    uint64_t bar;                   // rank 0: every peer's partial has landed
    float acc[DEC_MAX_CLUSTER][D];
    float ml[DEC_MAX_CLUSTER][2];

    __device__ __forceinline__ static float ex(float x) { return LOG2 ? hopper::ex2(x) : expf(x); }

    // thread 0, before the CTA's first barrier
    __device__ __forceinline__ void init(int rank, int n) {
        if (rank == 0 && n > 1) hopper::mbar_init(&bar, (n - 1) * D);
    }

    // threads tid < D
    __device__ __forceinline__ void finish(const DecodeParams& p, int rank, int n, int tid, int b, int h,
                                           float mt, float lt, float at) {
        if (rank != 0) {
            // hand the partial to rank 0 (a dead share's is m = M_FLOOR,
            // l = 0, acc = 0) and leave: nothing reads this CTA's memory
            hopper::st_cluster(hopper::cluster_map(&acc[rank][tid], 0), at);
            if (tid == 0) {
                hopper::st_cluster(hopper::cluster_map(&ml[rank][0], 0), mt);
                hopper::st_cluster(hopper::cluster_map(&ml[rank][1], 0), lt);
            }
            hopper::mbar_arrive_cluster(hopper::cluster_map(&bar, 0));
            return;
        }
        if (n > 1) hopper::mbar_wait_cluster(&bar, 0);
        float mi[DEC_MAX_CLUSTER];
        float mx = mt;
#pragma unroll
        for (int j = 1; j < DEC_MAX_CLUSTER; ++j)
            if (j < n) {
                mi[j] = ml[j][0];
                mx = fmaxf(mx, mi[j]);
            }
        float w = ex(mt - mx);
        float lsum = lt * w, asum = at * w;
#pragma unroll
        for (int j = 1; j < DEC_MAX_CLUSTER; ++j)
            if (j < n) {
                w = ex(mi[j] - mx);
                lsum += ml[j][1] * w;
                asum += acc[j][tid] * w;
            }
        T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
        op[tid] = from_float<T>(asum / lsum);
    }
};

// TMA loads of tile t's live rows (K, then V) into its stage of the ring,
// for a CTA's share [k0, k0 + span) clipped at kend.  Cf gives KT (keys a
// tile), STAGES, STAGE (bytes a stage), TILE (bytes of a K tile), BOXES
// (TMA boxes across a row), BOX_COLS, BOX_BYTES (bytes of one box of
// DEC_SUB rows) and BOX_STRIDE (bytes between the column boxes of a tile).
template <typename Cf>
struct Ring {
    const DecodeParams& p;
    uint8_t* base;
    uint64_t* full;
    int h, b, k0, kend;

    // live boxes of tile t (0 for a tile past the frontier)
    __device__ __forceinline__ int boxes(int t) const {
        const int rows = min(Cf::KT, kend - (k0 + t * Cf::KT));
        return rows > 0 ? (rows + DEC_SUB - 1) / DEC_SUB : 0;
    }
    // TMA loads of boxes [first, last) of tile t into its stage: a whole
    // tile as one box a column box, else box by box
    __device__ __forceinline__ void load(int t, int first, int last) const {
        uint64_t* bar = &full[t % Cf::STAGES];
        uint8_t* dst = base + (t % Cf::STAGES) * Cf::STAGE;
        const int row0 = k0 + t * Cf::KT;
        if (first == 0 && last * DEC_SUB == Cf::KT) {
#pragma unroll
            for (int bx = 0; bx < Cf::BOXES; ++bx) {
                hopper::tma_load_4d(dst + bx * Cf::BOX_STRIDE, &p.k, bar, bx * Cf::BOX_COLS, h, row0, b);
                hopper::tma_load_4d(dst + Cf::TILE + bx * Cf::BOX_STRIDE, &p.v, bar, bx * Cf::BOX_COLS, h, row0, b);
            }
            return;
        }
        for (int i = first; i < last; ++i)
#pragma unroll
            for (int bx = 0; bx < Cf::BOXES; ++bx) {
                const int off = bx * Cf::BOX_STRIDE + i * Cf::BOX_BYTES;
                hopper::tma_load_4d(dst + off, &p.k_sub, bar, bx * Cf::BOX_COLS, h, row0 + i * DEC_SUB, b);
                hopper::tma_load_4d(dst + Cf::TILE + off, &p.v_sub, bar, bx * Cf::BOX_COLS, h, row0 + i * DEC_SUB, b);
            }
    }
    __device__ __forceinline__ uint32_t bytes(int nbox) const { return 2u * nbox * Cf::BOXES * Cf::BOX_BYTES; }
    // thread 0: all live boxes of tile t, behind their expected bytes
    __device__ __forceinline__ void load_tile(int t) const {
        const int nb = boxes(t);
        hopper::mbar_expect_tx(&full[t % Cf::STAGES], bytes(nb));
        load(t, 0, nb);
    }
};

// ---------------------------------------------------------------- bf16, fp16

// a packed pair of T as two floats
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t x);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// T: the 16-bit query, cache and output type
template <typename T, int D>
struct MmaCfg {
    static constexpr int WARPS = 8;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int KT = 16 * WARPS;                   // keys per tile, 16 a warp
    static constexpr int DT = HeadDim<D>::TILE;             // D 80, 96: D 128's boxes
    static constexpr int ROWB = DT >= 64 ? 128 : 64;        // bytes of a swizzled box row
    static constexpr int CPB = ROWB / 16;                   // 16-byte chunks per box row
    static constexpr int BOX_COLS = ROWB / 2;
    static constexpr int BOXES = DT / BOX_COLS;             // column boxes across a row
    static_assert(BOXES * BOX_COLS == DT && D > (BOXES - 1) * BOX_COLS, "each box holds a column of D");
    static constexpr int BOX_BYTES = DEC_SUB * ROWB;
    static constexpr int BOX_STRIDE = KT * ROWB;
    static constexpr int TILE = BOXES * BOX_STRIDE;         // a [KT, D] tile in its boxes
    // q . K^T in 32-column steps of two mma.sync each, the second of the
    // last step left out where D ends 16 columns into it (D 80)
    static constexpr int KSTEPS = D / 16;
    static constexpr int K2 = (KSTEPS + 1) / 2;
    // one CTA an SM at the tile of 128 (its ring alone takes two stages of
    // 64 KB), so that ptxas gives the D 80 and 96 accumulators the
    // registers D 128's take rather than aim at two CTAs an SM and spill
    static constexpr int MIN_CTAS = DT == 128 ? 1 : 2;
    static constexpr int STAGE = 2 * TILE;                  // K, then V
    static constexpr int STAGES = DEC_RING / STAGE < 2 ? 2 : DEC_RING / STAGE > 8 ? 8 : DEC_RING / STAGE;
    static constexpr int RING = STAGES * STAGE;
    static_assert(WARPS * (D + 2) * 4 <= RING, "the warp merge reuses the ring");
    static constexpr int SMEM = RING + 1024;                // + the swizzle's 1024-byte alignment
};

// byte offset of 16-byte chunk c of row r in a [KT, D] tile as TMA writes
// it under the box swizzle (boxes of 64 columns, or one of 32 at D = 32)
template <typename Cf>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
    return (c / Cf::CPB) * Cf::BOX_STRIDE + hopper::swizzled<Cf::ROWB>(r, c % Cf::CPB);
}

// Each warp takes 16 keys of a tile: S = q . K^T on mma.sync with q in
// row 0 of A (rows 1-15 zero), its online softmax on lanes 0-3 (row 0 of
// the fragment), and O += P . V with P = hi + lo, two 16-bit parts, as the
// A operand straight from the S fragment.
template <typename T, int D>
__global__ void __launch_bounds__(MmaCfg<T, D>::THREADS, MmaCfg<T, D>::MIN_CTAS) decode_attn_mma(const __grid_constant__ DecodeParams p) {
    using Cf = MmaCfg<T, D>;
    constexpr int KT = Cf::KT, STAGES = Cf::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    __shared__ uint64_t full[STAGES];
    __shared__ Combine<T, D, true> comb;

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int rank = blockIdx.x;    // the cluster spans grid.x
    const int n = gridDim.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int pos_b = p.pos != nullptr ? p.pos[b] : p.pos_scalar;
    // without a window share 0 always holds key 0: its first box needs no pos
    const bool early = rank == 0 && p.window <= 0;
    // q as row 0 of the A operand: lanes 0-3 hold columns 2 lane, +1 and
    // 2 lane + 8, +9 of each 16-column step, everything else is zero
    uint32_t qa[Cf::KSTEPS][2];
    {
        const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + 2 * lane;
#pragma unroll
        for (int kk = 0; kk < Cf::KSTEPS; ++kk) {
            qa[kk][0] = lane < 4 ? *reinterpret_cast<const uint32_t*>(qp + 16 * kk) : 0u;
            qa[kk][1] = lane < 4 ? *reinterpret_cast<const uint32_t*>(qp + 16 * kk + 8) : 0u;
        }
    }
    Ring<Cf> rg{p, ring, full, h, b, 0, 0};
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
        comb.init(rank, n);
        hopper::fence_barrier_init();
        if (early) {
            hopper::mbar_expect_tx_only(&full[0], rg.bytes(1));
            rg.load(0, 0, 1);
        }
    }
    // rank 0's combine barrier is initialised before any peer arrives on
    // it (and this CTA's barriers before its threads wait on them)
    if (n > 1)
        hopper::cluster_sync();
    else
        __syncthreads();

    const int npos = min(p.Smax, pos_b + 1);        // visible keys
    const int k0 = band_start(p, pos_b) + rank * p.span;   // this share's first key
    const int kend = min(npos, k0 + p.span);
    rg.k0 = k0;
    rg.kend = kend;
    int ntiles = kend > k0 ? (kend - k0 + KT - 1) / KT : 0;   // CTA-uniform
    if (early) ntiles = max(ntiles, 1);             // its first box is in flight

    float mt = DS_M_FLOOR, lt = 0.f, at = 0.f;      // the CTA's partial (column tid)
    if (ntiles > 0) {
        if (tid == 0) {
            int t = 0;
            if (early) {                            // the rest of tile 0
                const int nb = max(rg.boxes(0), 1);
                hopper::mbar_expect_tx(&full[0], rg.bytes(nb - 1));
                rg.load(0, 1, nb);
                t = 1;
            }
            for (; t < min(STAGES, ntiles); ++t) rg.load_tile(t);
        }
        const float f0 = p.scale * hopper::LOG2E;   // scores in log2 units
        const float sl2 = alibi_slope(p, h) * hopper::LOG2E;
        float m = DS_M_FLOOR, l = 0.f;
        float o[D / 8][4];
#pragma unroll
        for (int db = 0; db < D / 8; ++db)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[db][e] = 0.f;
        for (int t = 0; t < ntiles; ++t) {
            const int s = t % STAGES;
            const int rows = min(KT, kend - (k0 + t * KT));   // live rows of the tile
            hopper::mbar_wait(&full[s], (t / STAGES) & 1);
            uint8_t* kt = ring + s * Cf::STAGE;
            const uint32_t ks_addr = hopper::smem_u32(kt);
            const uint32_t vs_addr = ks_addr + Cf::TILE;
            const int r0 = 16 * warp;     // this warp's first key row in the tile: one box
            if (r0 < rows) {              // warp-uniform: a warp past the frontier idles
                if (r0 + 16 > rows) {
                    // the box's V rows past the frontier (stale cache
                    // slots) are zeroed, so that p = 0 times them is 0 even
                    // if they hold no finite value; a warp reads only its
                    // own box
                    for (int id = lane; id < (r0 + 16 - rows) * (D / 8); id += 32)
                        *reinterpret_cast<uint4*>(kt + Cf::TILE + chunk_at<Cf>(rows + id / (D / 8), id % (D / 8))) =
                            make_uint4(0u, 0u, 0u, 0u);
                    __syncwarp();
                }
                // S = q . K^T for keys r0 .. r0 + 15 (two blocks of 8)
                float sf[2][4];
#pragma unroll
                for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) sf[nb][e] = 0.f;
#pragma unroll
                    for (int k2 = 0; k2 < Cf::K2; ++k2) {
                        // (at D 80 the last step's second half reads the
                        // box's zero-filled columns, and is not multiplied)
                        uint32_t kb[4];
                        hopper::ldmatrix_x4<false>(kb, ks_addr + chunk_at<Cf>(r0 + 8 * nb + lane % 8, 4 * k2 + lane / 8));
                        const uint32_t a0[4] = {qa[2 * k2][0], 0u, qa[2 * k2][1], 0u};
                        hopper::mma_16816<T>(sf[nb], a0, kb[0], kb[1]);
                        if (2 * k2 + 1 < Cf::KSTEPS) {
                            const uint32_t a1[4] = {qa[2 * k2 + 1][0], 0u, qa[2 * k2 + 1][1], 0u};
                            hopper::mma_16816<T>(sf[nb], a1, kb[2], kb[3]);
                        }
                    }
                }
                // scores of lanes 0-3 (row 0): keys r0 + 8 nb + 2 lane + e,
                // each at or above the band's start (the share starts there)
                const int j0 = k0 + t * KT + r0 + 2 * lane;
                float sc[4];
                float smax = -INFINITY;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int j = j0 + 8 * (i / 2) + i % 2;
                    const float x = fmaf(sf[i / 2][i % 2], f0, -sl2 * static_cast<float>(pos_b - j));
                    sc[i] = (lane < 4 && j < kend) ? x : -INFINITY;
                    smax = fmaxf(smax, sc[i]);
                }
                smax = hopper::quad_max(smax);
                const float m_new = fmaxf(m, smax);
                const float alpha = hopper::ex2(m - m_new);
                l *= alpha;
#pragma unroll
                for (int db = 0; db < D / 8; ++db)
#pragma unroll
                    for (int e = 0; e < 4; ++e) o[db][e] *= alpha;
                float pv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    pv[i] = hopper::ex2(sc[i] - m_new);
                    l += pv[i];
                }
                m = m_new;
                // P = hi + lo as the A operand: row 0 keys 2 lane, +1 (a0)
                // and 8 + 2 lane, +1 (a2)
                const uint32_t h0 = hopper::pack2<T>(pv[0], pv[1]), h1 = hopper::pack2<T>(pv[2], pv[3]);
                const float2 f0h = unpack2<T>(h0), f1h = unpack2<T>(h1);
                const uint32_t ahi[4] = {h0, 0u, h1, 0u};
                const uint32_t alo[4] = {hopper::pack2<T>(pv[0] - f0h.x, pv[1] - f0h.y), 0u,
                                         hopper::pack2<T>(pv[2] - f1h.x, pv[3] - f1h.y), 0u};
#pragma unroll
                for (int d2 = 0; d2 < Cf::KSTEPS; ++d2) {
                    uint32_t vb[4];
                    hopper::ldmatrix_x4<true>(vb, vs_addr + chunk_at<Cf>(r0 + lane % 8 + 8 * ((lane / 8) % 2), 2 * d2 + lane / 16));
                    hopper::mma_16816<T>(o[2 * d2], ahi, vb[0], vb[1]);
                    hopper::mma_16816<T>(o[2 * d2], alo, vb[0], vb[1]);
                    hopper::mma_16816<T>(o[2 * d2 + 1], ahi, vb[2], vb[3]);
                    hopper::mma_16816<T>(o[2 * d2 + 1], alo, vb[2], vb[3]);
                }
            }
            __syncthreads();                  // every warp is done with the stage
            if (tid == 0 && t + STAGES < ntiles) rg.load_tile(t + STAGES);
        }

        l = hopper::quad_sum(l);
        if (n == 1 && kend - k0 <= DEC_SUB) {
            // only warp 0 saw keys and no peer waits: it writes O itself
            if (warp == 0 && lane < 4) {
                T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + 2 * lane;
#pragma unroll
                for (int db = 0; db < D / 8; ++db)
                    *reinterpret_cast<uint32_t*>(op + 8 * db) = hopper::pack2<T>(o[db][0] / l, o[db][1] / l);
            }
            return;
        }
        // merge the warps' (m, l, o) in warp order; the ring is free
        float* m_s = reinterpret_cast<float*>(ring);
        float* l_s = m_s + Cf::WARPS;
        float* o_s = l_s + Cf::WARPS;                   // [WARPS][D]
        if (lane == 0) { m_s[warp] = m; l_s[warp] = l; }
        if (lane < 4)
#pragma unroll
            for (int db = 0; db < D / 8; ++db) {
                o_s[warp * D + 8 * db + 2 * lane] = o[db][0];
                o_s[warp * D + 8 * db + 2 * lane + 1] = o[db][1];
            }
        __syncthreads();
        if (tid < D) {
            for (int w = 0; w < Cf::WARPS; ++w) mt = fmaxf(mt, m_s[w]);
            for (int w = 0; w < Cf::WARPS; ++w) {
                const float wt = hopper::ex2(m_s[w] - mt);
                lt += l_s[w] * wt;
                at += o_s[w * D + tid] * wt;
            }
        }
    }
    if (tid < D) comb.finish(p, rank, n, tid, b, h, mt, lt, at);
}

// ---------------------------------------------------------------- fp32, int8

// 16 int8 codes as fp32, exactly, on integer and add units (the
// int-to-float converter runs at a quarter of their rate): the byte
// c + 128 becomes the low mantissa byte of 2^23 + (c + 128)
__device__ __forceinline__ void widen16_fast(const uint4& r, float* out) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
        out[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 | (i % 4))) - 8388736.f;
}

// T: the query and output type; C: the cache's (float with T, or int8_t
// codes with any T)
template <typename T, typename C, int D>
struct FmaCfg {
    static constexpr int THREADS = 256;
    static constexpr int STAGES = 3;
    static constexpr int VEC = VecWidth<C>::value;          // cache elements per 16 bytes
    static constexpr int VPR = D / VEC;                     // 16-byte vectors of a row
    static_assert(VPR * VEC == D && VPR <= 32, "whole 16-byte vectors a row, a warp at most");
    // lanes per key row: the next power of two of VPR (the group merge's
    // butterfly and the row sums' shuffles stay within a group); lanes
    // VPR .. TPK - 1 of a group idle (D 80, 96)
    static constexpr int TPK = VPR <= 1 ? 1 : VPR <= 2 ? 2 : VPR <= 4 ? 4 : VPR <= 8 ? 8 : VPR <= 16 ? 16 : 32;
    static constexpr int G = THREADS / TPK;                 // key groups
    static constexpr int U = 2;                             // keys per group per tile
    static constexpr int KT = U * G;                        // keys per tile
    static constexpr int ROW_BYTES = D * static_cast<int>(sizeof(C));
    static constexpr int BOX_COLS = D;                      // one unswizzled box across a row
    static constexpr int BOXES = 1;
    static constexpr int BOX_BYTES = DEC_SUB * ROW_BYTES;
    static constexpr int BOX_STRIDE = 0;
    static constexpr int TILE = KT * ROW_BYTES;             // U * THREADS * 16 bytes
    static constexpr int STAGE = 2 * TILE;                  // K, then V
    static constexpr int RING = STAGES * STAGE;
    static_assert((THREADS / 32 * (D + 2)) * 4 <= RING, "the warp merge reuses the ring");
    static_assert(KT % DEC_SUB == 0, "whole boxes a tile");
    static constexpr int SMEM = RING + 128;                 // + alignment slack
};

// G groups of TPK lanes, a group U keys of each tile (key u G + g),
// one 16-byte shared-memory read per lane per key row, fp32 FMAs.  Over
// int8 codes the scales multiply the row's sum, S_j = k_scale_j (q .
// codes_j) and acc += (p_j v_scale_j) codes_j, not each element.
template <typename T, typename C, int D>
__global__ void __launch_bounds__(FmaCfg<T, C, D>::THREADS) decode_attn_fma(const __grid_constant__ DecodeParams p) {
    using Cf = FmaCfg<T, C, D>;
    constexpr bool Q8 = std::is_same<C, int8_t>::value;
    constexpr int VEC = Cf::VEC, TPK = Cf::TPK, G = Cf::G, KT = Cf::KT, U = Cf::U, STAGES = Cf::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
    __shared__ uint64_t full[STAGES];
    __shared__ Combine<T, D, false> comb;

    const int tid = threadIdx.x;
    const int g = tid / TPK;
    const int lane = tid % TPK;
    const int rank = blockIdx.x;
    const int n = gridDim.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int pos_b = p.pos != nullptr ? p.pos[b] : p.pos_scalar;
    const bool early = rank == 0 && p.window <= 0;
    // a lane past the row (D 80, 96) reads nothing and adds 0 to its row's
    // sums; its accumulator is never stored
    const bool in_row = Cf::VPR == TPK || lane < Cf::VPR;
    float qf[VEC];
    if (in_row) {
        load_widen<T, VEC>(static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + lane * VEC, qf);
    } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[e] = 0.f;
    }

    Ring<Cf> rg{p, ring, full, h, b, 0, 0};
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
        comb.init(rank, n);
        hopper::fence_barrier_init();
        if (early) {
            hopper::mbar_expect_tx_only(&full[0], rg.bytes(1));
            rg.load(0, 0, 1);
        }
    }
    if (n > 1)
        hopper::cluster_sync();
    else
        __syncthreads();

    const int npos = min(p.Smax, pos_b + 1);
    const int k0 = band_start(p, pos_b) + rank * p.span;
    const int kend = min(npos, k0 + p.span);
    rg.k0 = k0;
    rg.kend = kend;
    int ntiles = kend > k0 ? (kend - k0 + KT - 1) / KT : 0;
    if (early) ntiles = max(ntiles, 1);

    float mt = DS_M_FLOOR, lt = 0.f, at = 0.f;
    if (ntiles > 0) {
        if (tid == 0) {
            int t = 0;
            if (early) {
                const int nb = max(rg.boxes(0), 1);
                hopper::mbar_expect_tx(&full[0], rg.bytes(nb - 1));
                rg.load(0, 1, nb);
                t = 1;
            }
            for (; t < min(STAGES, ntiles); ++t) rg.load_tile(t);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[e] *= p.scale;
        const float slope = alibi_slope(p, h);
        const float* ksp = Q8 ? p.k_scale + b * p.ks_sb + h * p.ks_sh : nullptr;
        const float* vsp = Q8 ? p.v_scale + b * p.vs_sb + h * p.vs_sh : nullptr;
        // the scales of this group's keys in tile t (0 past the frontier)
        auto fetch = [&](int t, float (&ks)[U], float (&vs)[U]) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const long long j = k0 + t * KT + u * G + g;
                const bool ok = j < kend;
                ks[u] = ok ? __ldg(ksp + j * p.ks_ss) : 0.f;
                vs[u] = ok ? __ldg(vsp + j * p.vs_ss) : 0.f;
            }
        };
        float ksc[U] = {}, vsc[U] = {};
        if constexpr (Q8) fetch(0, ksc, vsc);

        float m = DS_M_FLOOR, l = 0.f;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        for (int t = 0; t < ntiles; ++t) {
            const int s = t % STAGES;
            float ksn[U] = {}, vsn[U] = {};
            if constexpr (Q8) {
                if (t + 1 < ntiles) fetch(t + 1, ksn, vsn);
            }
            hopper::mbar_wait(&full[s], (t / STAGES) & 1);
            const uint8_t* kt = ring + s * Cf::STAGE + lane * 16;
            const uint8_t* vt = kt + Cf::TILE;
            const int j0 = k0 + t * KT + g;   // this group's key at u = 0
            float sc[U];
            float smax = -INFINITY;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                // a row past the frontier may not have been loaded: its
                // score is -inf by the select, and its V row is skipped
                const uint4 raw = in_row ? *reinterpret_cast<const uint4*>(kt + (u * G + g) * Cf::ROW_BYTES)
                                         : make_uint4(0u, 0u, 0u, 0u);
                float kf[VEC];
                if constexpr (Q8)
                    widen16_fast(raw, kf);
                else
                    widen16(raw, kf, C());
                float part = 0.f;
#pragma unroll
                for (int e = 0; e < VEC; ++e) part += qf[e] * kf[e];
                // the TPK lanes of a key row are neighbours in one warp
#pragma unroll
                for (int o = TPK / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
                if constexpr (Q8) part *= ksc[u];
                part = fmaf(-slope, static_cast<float>(pos_b - (j0 + u * G)), part);
                sc[u] = j0 + u * G < kend ? part : -INFINITY;
                smax = fmaxf(smax, sc[u]);
            }
            const float m_new = fmaxf(m, smax);
            const float alpha = expf(m - m_new);
            l *= alpha;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (j0 + u * G < kend) {
                    const float pw = expf(sc[u] - m_new);
                    const uint4 raw = in_row ? *reinterpret_cast<const uint4*>(vt + (u * G + g) * Cf::ROW_BYTES)
                                             : make_uint4(0u, 0u, 0u, 0u);
                    float vf[VEC];
                    if constexpr (Q8)
                        widen16_fast(raw, vf);
                    else
                        widen16(raw, vf, C());
                    const float pv = Q8 ? pw * vsc[u] : pw;
                    l += pw;
#pragma unroll
                    for (int e = 0; e < VEC; ++e) acc[e] += pv * vf[e];
                }
            }
            m = m_new;
            if constexpr (Q8) {
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    ksc[u] = ksn[u];
                    vsc[u] = vsn[u];
                }
            }
            __syncthreads();                  // every thread is done with stage s
            if (tid == 0 && t + STAGES < ntiles) rg.load_tile(t + STAGES);
        }

        // merge the groups: first the 32 / TPK of each warp, by shuffles
        // over the group bits of the lane (a fixed butterfly), then the
        // warps' states in warp order through shared memory (the ring is
        // free)
#pragma unroll
        for (int o = TPK; o < 32; o <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
            const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
            const float mm = fmaxf(m, m2);
            const float w1 = expf(m - mm), w2 = expf(m2 - mm);
            l = l * w1 + l2 * w2;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = acc[e] * w1 + __shfl_xor_sync(0xffffffffu, acc[e], o) * w2;
            m = mm;
        }
        constexpr int WARPS = Cf::THREADS / 32;
        float* acc_s = reinterpret_cast<float*>(ring);   // [WARPS][D]
        float* m_s = acc_s + WARPS * D;
        float* l_s = m_s + WARPS;
        const int warp = tid / 32;
        if (tid % 32 == lane) {                          // the warp's first group
            if (lane == 0) { m_s[warp] = m; l_s[warp] = l; }
            if (in_row) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc_s[warp * D + lane * VEC + e] = acc[e];
            }
        }
        __syncthreads();
        if (tid < D) {
            for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, m_s[w]);
            for (int w = 0; w < WARPS; ++w) {
                const float wt = expf(m_s[w] - mt);
                lt += l_s[w] * wt;
                at += acc_s[w * D + tid] * wt;
            }
        }
    }
    if (tid < D) comb.finish(p, rank, n, tid, b, h, mt, lt, at);
}

// ---------------------------------------------------------------- host

// the cache as the maps see it
struct CacheView {
    const void* k; const void* v;
    long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// Build the maps of K and V, fix the split and launch `kernel` as n-CTA
// clusters over (b, h): the largest n (a power of two <= 8) whose B * H * n
// CTAs fit one wave at one CTA a SM, and no more ranks than KT-key tiles
// of the live keys: S_max (or a scalar pos), or the window where it is
// fewer.  A per-row pos is never read on the host.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, int kt, int map_type, int esz, DecodeParams& p,
                   const CacheView& c, int B, int H, int D, bool& ready, cudaStream_t stream) {
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        ready = true;
    }
    // whole tiles, and boxes of DEC_SUB rows: 16-bit rows under the box
    // swizzle, fp32 rows and int8 codes unswizzled
    auto map = [&](CUtensorMap* m, const void* base, long long sb, long long ss, long long sh, int rows) {
        return map_type >= 0 ? hopper::map_rows(m, base, map_type, B, p.Smax, H, D, sb, ss, sh, rows)
                             : hopper::map_rows_linear(m, base, esz, B, p.Smax, H, D, sb, ss, sh, rows);
    };
    cudaError_t err = map(&p.k, c.k, c.k_sb, c.k_ss, c.k_sh, kt);
    if (err == cudaSuccess) err = map(&p.v, c.v, c.v_sb, c.v_ss, c.v_sh, kt);
    if (err == cudaSuccess) err = map(&p.k_sub, c.k, c.k_sb, c.k_ss, c.k_sh, DEC_SUB);
    if (err == cudaSuccess) err = map(&p.v_sub, c.v, c.v_sb, c.v_ss, c.v_sh, DEC_SUB);
    if (err != cudaSuccess) return err;
    int live = p.pos != nullptr ? p.Smax : min(p.Smax, p.pos_scalar + 1);
    if (p.window > 0) live = min(live, p.window);
    const int tiles = max(1, (live + kt - 1) / kt);
    int n = 1;
    while (n < DEC_MAX_CLUSTER && 2 * n <= tiles && (long long)B * H * 2 * n <= sm_count()) n *= 2;
    p.span = (tiles + n - 1) / n * kt;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n, H, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = n;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = n > 1 ? 1 : 0;   // no split: a plain launch
    void* args[] = {&p};
    err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(DecodeParams& p, const CacheView& c, int B, int H, cudaStream_t s) {
    using Cf = MmaCfg<T, D>;
    static bool ready = false;
    return launch(decode_attn_mma<T, D>, Cf::THREADS, Cf::SMEM, Cf::KT,
                  std::is_same<T, __nv_bfloat16>::value ? kBF16 : kF16, 0, p, c, B, H, D, ready, s);
}

template <typename T, typename C, int D>
cudaError_t launch_fma(DecodeParams& p, const CacheView& c, int B, int H, cudaStream_t s) {
    using Cf = FmaCfg<T, C, D>;
    static bool ready = false;
    return launch(decode_attn_fma<T, C, D>, Cf::THREADS, Cf::SMEM, Cf::KT, -1, sizeof(C), p, c, B, H, D, ready, s);
}

// A cache of the query's 16-bit type goes to the mma kernel; fp32, and
// int8 codes under any query type, to the FMA kernel.
template <bool Q8>
int dispatch_decode(int dtype, int B, int H, int D, DecodeParams& p, const CacheView& c, cudaStream_t s) {
#define DS_DECODE_D(CALL)                                                  \
    switch (D) {                                                           \
        case 32: return static_cast<int>(CALL(32));                       \
        case 64: return static_cast<int>(CALL(64));                       \
        case 80: return static_cast<int>(CALL(80));                       \
        case 96: return static_cast<int>(CALL(96));                       \
        case 128: return static_cast<int>(CALL(128));                     \
        default: return static_cast<int>(cudaErrorInvalidValue);          \
    }
#define DS_F32(d) launch_fma<float, typename std::conditional<Q8, int8_t, float>::type, d>(p, c, B, H, s)
#define DS_BF16(d) (Q8 ? launch_fma<__nv_bfloat16, int8_t, d>(p, c, B, H, s) : launch_mma<__nv_bfloat16, d>(p, c, B, H, s))
#define DS_F16(d) (Q8 ? launch_fma<__half, int8_t, d>(p, c, B, H, s) : launch_mma<__half, d>(p, c, B, H, s))
    switch (dtype) {
        case kF32: DS_DECODE_D(DS_F32)
        case kF16: DS_DECODE_D(DS_F16)
        case kBF16: DS_DECODE_D(DS_BF16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DS_DECODE_D
#undef DS_F32
#undef DS_BF16
#undef DS_F16
}

}  // namespace

extern "C" int decode_attn(const void* q, const void* k, const void* v, void* o,
                           int dtype, int B, int Smax, int H, int D,
                           long long q_sb, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_sh,
                           const int* pos, int pos_scalar, int window, const float* slopes, float scale,
                           void* stream) {
    if (B == 0 || H == 0) return 0;
    if (Smax <= 0) return static_cast<int>(cudaErrorInvalidValue);
    DecodeParams p{};
    p.q = q; p.o = o; p.pos = pos; p.pos_scalar = pos_scalar; p.Smax = Smax;
    p.window = window; p.slopes = slopes;
    p.q_sb = q_sb; p.q_sh = q_sh; p.o_sb = o_sb; p.o_sh = o_sh;
    p.scale = scale;
    const CacheView c{k, v, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    return dispatch_decode<false>(dtype, B, H, D, p, c, static_cast<cudaStream_t>(stream));
}

// k, v: int8 codes; k_scale, v_scale: fp32 [B, S_max, H, 1] through strides
extern "C" int decode_attn_int8(const void* q, const void* k, const void* v, void* o,
                                int dtype, int B, int Smax, int H, int D,
                                long long q_sb, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_sh,
                                const float* k_scale, const float* v_scale,
                                long long ks_sb, long long ks_ss, long long ks_sh,
                                long long vs_sb, long long vs_ss, long long vs_sh,
                                const int* pos, int pos_scalar, int window, const float* slopes, float scale,
                                void* stream) {
    if (B == 0 || H == 0) return 0;
    if (Smax <= 0) return static_cast<int>(cudaErrorInvalidValue);
    DecodeParams p{};
    p.q = q; p.o = o; p.pos = pos; p.pos_scalar = pos_scalar; p.Smax = Smax;
    p.window = window; p.slopes = slopes;
    p.q_sb = q_sb; p.q_sh = q_sh; p.o_sb = o_sb; p.o_sh = o_sh;
    p.k_scale = k_scale; p.v_scale = v_scale;
    p.ks_sb = ks_sb; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
    p.vs_sb = vs_sb; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
    p.scale = scale;
    const CacheView c{k, v, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    return dispatch_decode<true>(dtype, B, H, D, p, c, static_cast<cudaStream_t>(stream));
}
