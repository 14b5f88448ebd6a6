// flash_bwd_fused: the fused single-sweep flash-attention backward: dQ, dK
// and dV in one pass over the queries.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd_dkv_kernel (line 304) in its fused form (emit_dq=True, :312-320,
// 368-374, 382-384), which the JAX package runs whenever the keys span at
// most MAX_FUSED_BWD_NK = 4 blocks of 1024 (:397, 415-416): each key
// tile's CTA walks the queries that see it, as flash_bwd_dkv does, and
// also forms its share of dQ = dS.K.  JAX writes one fp32 dq partial per
// key block and lets XLA sum them (:450); here the key tiles that see a
// q-tile add their shares into one fp32 accumulator in a fixed order
// (below), so dq is bitwise repeatable.  Five matrix products per q-tile
// where the pair (flash_bwd_dq + flash_bwd_dkv) does seven, and q, k, v
// and dO are read once.  The rounding is the pair's (flash_bwd.cuh): dV
// from round_T(p), dS = round_T(p (dP - delta) scale), dq summed in fp32
// and rounded once.
//
// Bound on the H100: 10*D FLOPs per visible pair (S^T, dP^T, dV, dK, dQ)
// against the bytes of q, k, v, dO, lse and delta read once and dq, dk, dv
// written once; at GPT-2 350M's training shape (B16 S1024 H16 D64 causal)
// 8.6e10 FLOPs over 237 MB, above the card's 295 bf16 FLOPs per byte, so
// the least time is the operations over 989 TFLOP/s.  The accumulator's
// traffic (a write or an add in L2 per contributor) is the design's cost
// and outside the bound.
//
// The ordered sum.  The contributors of a q-tile are the key tiles whose
// walk includes it: under causal masking, the key length and a band, a
// contiguous range lo .. lo + n - 1 that every CTA computes alike
// (contributors()).  Key tile lo + r waits until the q-tile's counter reads
// r (ld.acquire), adds its share to the accumulator (the first stores it),
// and releases r + 1; the last adds, rounds the sum to T, writes dq through
// its strides and sets the counter back to 0, so the counters need no
// memset between launches.  A key tile's predecessors are always
// dispatched before it (the grid's order, below), so a CTA waits only on
// CTAs already running.  A wait that outlasts ~2^32 cycles traps, as the
// mbarrier waits do.  The q-tiles no key tile walks (causal rows that see
// no key) are written as zeros by key tile 0.  With wait_cycles given, the
// cycles CTAs spent waiting for their turn are summed there.
//
// bf16 and fp16 (flash_bwd_fused_tc): a CTA per (b, h, 128 keys) walks
// q-tiles of 64 queries at every head dim; 384 threads in three
// warpgroups, which share the register file unevenly (setmaxnreg: the two
// consumer warpgroups 232 registers a thread, the producer 40).
//   The consumers (64 keys each, K and V loaded once) compute per q-tile
//   S = Q.K^T and dP = dO.V^T as m64n64 products with the queries as the
//   M rows, as FlashAttention-3 does (a thread's lse and delta are its two
//   rows', not sixteen columns'), and write P and dS rounded to T into
//   shared [64 queries][128 keys] tiles (dS two, used in turns).  Once both
//   have (a named barrier), each runs in one group dV += P^T.dO and dK +=
//   dS^T.Q over its 64 keys (its box of the tiles read MN-major) and its
//   part of the CTA's dQ share = dS.K over the 128 keys (the dS tile
//   K-major, K MN-major): D 128 (and 80, 96) one 64-column box of K each,
//   D 64 one half of the box each, D 32 the first warpgroup alone.  No
//   operand stays in registers across a product, so a consumer holds dK,
//   dV and either S and dP or the share.  The share goes from the wgmma
//   fragment into a staging tile (two where shared memory allows, else
//   one) in the fragment's own layout (each thread's values at 16-byte
//   vectors of their own), which the accumulator in global memory keeps.
//   The producer's first warp keeps the ring of Q, dO, lse and delta
//   loaded; its second warp's first lane adds each staged share in key
//   order: the first contributor stores it with a bulk copy, a middle one
//   adds it with a bulk reduce-add (in L2: the sum never comes back to the
//   SM), the last one reduce-adds it too and bulk-loads the whole sum back
//   into the staging tile, which warps 1-3 round to T into dq.  The bulk
//   group is complete (cp.async.bulk.wait_group, the async proxy fenced)
//   before the next turn is released.  The consumers wait on the sum only
//   when every staging tile is still in it.  A q-tile with one
//   contributor (every q-tile of a short sequence) has no sum: the
//   consumers round their share into dq themselves.
//
// Order.  Each CTA walks its q-tiles from the last down, and the grid
// takes (b, h) pairs in dispatch groups, key tile by key tile within a
// group (dispatch_group()): key tile j of a (b, h) starts a few q-tiles of
// work after key tile j - 1 and finds it ahead on every q-tile, while the
// q-tiles' running sums are still in L2.
//
// fp32 (flash_fused_fma): flash_dkv_fma's sweep (a CTA of 128 threads per
// (b, h, key tile), a key row on DT/16 lanes), plus each q-tile's dS in
// shared memory and the CTA's dQ share = dS.K from its keys on FMAs,
// summed in the same order (k-tile-major grid, ascending q-tiles).
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// DT = 128 (common.cuh tile_dim): the tensor-core kernel's S^T and dP^T
// stop at D's last 16-column step, dK, dV and the dQ share are computed
// over the padded columns (zeros TMA fills in) and stored below D only;
// the FMA kernel pads its rows with zeros.  The workspace's sum is
// [BQ, DT] per q-tile either way (BQ: FusedCfg's, FmaTile's).
#include <algorithm>

#include "attn_tc.cuh"
#include "flash_bwd.cuh"

struct FusedWs {
    float* acc;                         // per (b, h, q-tile) BQ * D fp32, in the kernel's order
    int* counters;                      // per (b, h, q-tile), 0 between launches
    unsigned long long* wait_cycles;    // optional: the cycles CTAs spent waiting, summed
};

__device__ __forceinline__ int floordiv(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

// The key tiles (KT keys each) whose walk covers the q-tile of BQ rows at
// q0, given row b's key limit: (first, count).  A key tile j walks from
// the q-tile of its first query (k0 - off under causal masking) to the
// last query that sees its last key (under a band), if k0 < klim.
template <int BQ>
__device__ __forceinline__ int2 contributors(int q0, int klim, int off, bool causal, int win, int KT) {
    int hi = (klim + KT - 1) / KT - 1;
    if (causal) hi = min(hi, floordiv(q0 + BQ - 1 + off, KT));
    const int lo = win > 0 ? max(0, floordiv(q0 + off - win - (KT - 1), KT) + 1) : 0;
    return make_int2(lo, max(0, hi - lo + 1));
}

// dq rows of every q-tile that no key tile walks, as zeros (key tile 0)
template <typename T, int D, int KT, int BQ>
__device__ void zero_unwalked(T* dqp, long long dq_ss, int Sq, int klim, int off, bool causal, int win) {
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
        if (contributors<BQ>(q0, klim, off, causal, win, KT).y > 0) continue;
        const int rows = min(BQ, Sq - q0);
        for (int id = threadIdx.x; id < rows * D; id += blockDim.x)
            dqp[(long long)(q0 + id / D) * dq_ss + id % D] = from_float<T>(0.f);
    }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// this thread's writes, and those ordered before them by a barrier, are
// visible to the thread that reads v with ld_acquire
__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// spin until *cnt reads `want`; the cycles waited.  A wait of ~2^32 cycles
// (seconds) can only be a fault of the bookkeeping: trap.
__device__ __forceinline__ long long wait_turn(const int* cnt, int want) {
    if (ld_acquire(cnt) == want) return 0;
    const long long start = clock64();
    while (ld_acquire(cnt) != want)
        if (clock64() - start > (1ll << 32)) __trap();
    return clock64() - start;
}

// The fp32 kernel's turn: contributor `rank` of `n` adds this thread's NV
// vectors of the CTA's share of q-tile `tile` (v) to the accumulator: the
// G threads of the share take part (gt: this thread's index among them;
// thread 0 waits and releases; sync() is their barrier).  The last hands
// the sum to store_dq instead and resets the counter.
template <int NV, int G, typename Sync, typename Store>
__device__ __forceinline__ void ordered_add(const FusedWs& ws, long long tile, int rank, int n, float4 (&v)[NV],
                                            int gt, long long& waited, const Sync& sync, const Store& store_dq) {
    if (static_cast<unsigned>(rank) >= static_cast<unsigned>(n)) __trap();
    int* cnt = ws.counters + tile;
    float4* acc = reinterpret_cast<float4*>(ws.acc) + tile * (NV * G) + gt;
    if (rank > 0) {
        if (gt == 0) waited += wait_turn(cnt, rank);
        sync();
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const float4 a = __ldcg(acc + i * G);
            v[i] = make_float4(a.x + v[i].x, a.y + v[i].y, a.z + v[i].z, a.w + v[i].w);
        }
    }
    if (rank == n - 1) {
        store_dq(v);
        if (rank > 0 && gt == 0) *cnt = 0;
        return;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) __stcg(acc + i * G, v[i]);
    sync();
    if (gt == 0) st_release(cnt, rank + 1);
}

// ------------------------------------------------------------------ fp32

// the fp32 kernel's q-tile, shared with the wrapper's workspace size
// (ops/kernels/flash_attention.py fused_q_tile)
template <int D> struct FmaTile {
    static constexpr int DT = HeadDim<D>::TILE;        // the padded row
    static constexpr int TPR = DT / 16;                // lanes per key row
    static constexpr int BK = DS_BWD_THREADS / TPR;    // keys per CTA
    static constexpr int BQ = DT <= 64 ? 64 : 32;      // queries per q-tile
    static constexpr int RT = DS_BWD_THREADS / BQ;     // threads per row of the dQ share
    static constexpr int NV = DT / 4 / RT;             // float4 of the share a thread holds
    static_assert(NV * RT * 4 == DT, "the share covers the padded row");
    static constexpr int SMEM = (2 * BQ + BK) * DT * 4 + BQ * (BK + 1) * 4 + 2 * BQ * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(DS_BWD_THREADS)
flash_fused_fma(const BwdArgs a, const FusedWs ws) {
    using F = FmaTile<D>;
    constexpr int DT = F::DT, TPR = F::TPR, BK = F::BK, BQ = F::BQ, NV = F::NV;
    constexpr int NCH = 4;                             // float4 chunks per lane
    extern __shared__ float4 fsm[];
    float4 (*qs)[DT / 4] = reinterpret_cast<float4 (*)[DT / 4]>(fsm);
    float4 (*dos)[DT / 4] = reinterpret_cast<float4 (*)[DT / 4]>(fsm + BQ * DT / 4);
    float4 (*ks)[DT / 4] = reinterpret_cast<float4 (*)[DT / 4]>(fsm + 2 * BQ * DT / 4);
    float (*dss)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(fsm + (2 * BQ + BK) * DT / 4);
    float* lses = &dss[0][0] + BQ * (BK + 1);
    float* deltas = lses + BQ;

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int t = tid % TPR;
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int kt = blockIdx.z;
    const int k0 = kt * BK;
    const int kj = k0 + r;
    const int klim = key_limit(a, b);
    const bool key_ok = kj < klim;
    const int off = a.Sk - a.Sq;
    const bool band = banded(a);
    const int win = band ? a.window : 0;
    T* dqp = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
    if (kt == 0) zero_unwalked<T, D, BK, BQ>(dqp, a.dq_ss, a.Sq, klim, off, a.causal, win);
    int qstart = a.causal ? max(0, k0 - off) : 0;
    qstart = k0 >= klim ? a.Sq : (qstart / BQ) * BQ;
    const int qend = band ? min(a.Sq, max(0, k0 + BK - 1 - off + a.window)) : a.Sq;

    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + (long long)kj * a.k_ss + h * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + (long long)kj * a.v_ss + h * a.v_sh;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long stat0 = ((long long)b * a.H + h) * a.Sq;
    const long long tile0 = ((long long)b * a.H + h) * ((a.Sq + BQ - 1) / BQ);

    float4 k[NCH], v[NCH], dk[NCH], dv[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const bool ok = key_ok && (c * TPR + t) * 4 < D;   // the padded columns: zero
        k[c] = ok ? load4(kp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[c] = ok ? load4(vp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        ks[r][c * TPR + t] = k[c];
    }
    // the dQ share's row and first column vector of this thread
    const int qr = tid / F::RT;
    const int cs = (tid % F::RT) * NV;
    long long waited = 0;

    for (int q0 = qstart; q0 < qend; q0 += BQ) {
        __syncthreads();                          // the previous tile is consumed
        load_rows<T, D, BQ, DT>(qs, qp, a.q_ss, q0, a.Sq);
        load_rows<T, D, BQ, DT>(dos, dop, a.do_ss, q0, a.Sq);
        for (int i = tid; i < BQ; i += DS_BWD_THREADS) {
            const bool ok = q0 + i < a.Sq;
            lses[i] = ok ? a.lse[stat0 + q0 + i] : 0.f;
            deltas[i] = ok ? a.delta[stat0 + q0 + i] : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int i = 0; i < BQ; ++i) {
            float4 qv[NCH], dov[NCH];
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                qv[c] = qs[i][c * TPR + t];
                dov[c] = dos[i][c * TPR + t];
                s += dot4(k[c], qv[c]);
                dp += dot4(v[c], dov[c]);
            }
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, o);
                dp += __shfl_xor_sync(0xffffffffu, dp, o);
            }
            const int qi = q0 + i;
            const bool vis = key_ok && qi < a.Sq && (!a.causal || kj <= qi + off) &&
                             (!band || qi + off - kj < a.window);
            float pr = 0.f, ds = 0.f;
            if (vis) {
                const float p = expf(s * a.scale - lses[i]);
                pr = round_to<T>(p);
                ds = round_to<T>(p * (dp - deltas[i]) * a.scale);
            }
            if (t == 0) dss[i][r] = ds;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                axpy4(dv[c], pr, dov[c]);
                axpy4(dk[c], ds, qv[c]);
            }
        }
        __syncthreads();
        // the CTA's dQ share of the q-tile: dS . K over its BK keys
        float4 o[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < BK; ++j) {
            const float s = dss[qr][j];
#pragma unroll
            for (int c = 0; c < NV; ++c) axpy4(o[c], s, ks[j][cs + c]);
        }
        const int2 ctb = contributors<BQ>(q0, klim, off, a.causal, win, BK);
        ordered_add<NV, DS_BWD_THREADS>(
            ws, tile0 + q0 / BQ, kt - ctb.x, ctb.y, o, tid, waited, [] { __syncthreads(); },
            [&](const float4 (&sum)[NV]) {
                if (q0 + qr >= a.Sq) return;
                T* row = dqp + (long long)(q0 + qr) * a.dq_ss + cs * 4;
#pragma unroll
                for (int c = 0; c < NV; ++c)
                    if (cs * 4 + 4 * c < D) store4(row + 4 * c, sum[c].x, sum[c].y, sum[c].z, sum[c].w);
            });
    }
    if (ws.wait_cycles != nullptr && tid == 0 && waited > 0)
        atomicAdd(ws.wait_cycles, static_cast<unsigned long long>(waited));

    if (kj >= a.Sk) return;
    T* dkp = static_cast<T*>(a.dk) + b * a.dk_sb + (long long)kj * a.dk_ss + h * a.dk_sh;
    T* dvp = static_cast<T*>(a.dv) + b * a.dv_sb + (long long)kj * a.dv_ss + h * a.dv_sh;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        if ((c * TPR + t) * 4 >= D) continue;
        store4(dkp + (c * TPR + t) * 4, dk[c].x, dk[c].y, dk[c].z, dk[c].w);
        store4(dvp + (c * TPR + t) * 4, dv[c].x, dv[c].y, dv[c].z, dv[c].w);
    }
}

template <typename T, int D>
static cudaError_t launch_fused_fma(const BwdArgs& a, const FusedWs& ws, cudaStream_t stream) {
    using F = FmaTile<D>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_fused_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(a.H, a.B, max(1, (a.Sk + F::BK - 1) / F::BK));
    flash_fused_fma<T, D><<<grid, DS_BWD_THREADS, F::SMEM, stream>>>(a, ws);
    return cudaGetLastError();
}

// ------------------------------------------------------ bf16 and fp16

namespace {

constexpr int FU_BK = 128;              // keys per CTA: two warpgroups of 64
constexpr int FU_THREADS = 384;         // two consumer warpgroups, the producer warpgroup
constexpr int BAR_CONS = 1;             // named barrier of the two consumer warpgroups
constexpr int BAR_SUM = 2;              // named barrier of the producer's warps 1-3
constexpr int SUM_THREADS = 96;         // the producer's warps 1-3: dq of a last contributor
// registers a thread after setmaxnreg, within the launch's 168 x 384:
// the producer keeps 40 (at FlashAttention-3's 24 ptxas spilled 12-52
// bytes in the ordered sum's loop), the consumers take the rest (at most
// 223 used at D 128)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 168 * FU_THREADS,
              "the consumers take no more registers than the producer gives back");

struct FusedParams {
    CUtensorMap k, v;                   // rows of 128 per box
    CUtensorMap q, dout;                // rows of BQ per box
    const float* lse; const float* delta;   // [B, H, Sq]
    void* dq; void* dk; void* dv;
    FusedWs ws;
    const int* kv_lens;
    int Sq, Sk, H, nkt;
    int group;                          // (b, h) pairs a dispatch group takes
    long long dq_sb, dq_ss, dq_sh;
    long long dk_sb, dk_ss, dk_sh;
    long long dv_sb, dv_ss, dv_sh;
    float scale;
    int causal;
    int window;                         // band width (causal only), 0: none
};

template <int D>
struct FusedCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;
    using attn_tc::Boxes<D>::ROWB;
    static constexpr int DT = attn_tc::Boxes<D>::DT;
    // queries per q-tile, shared with the wrapper's workspace size
    // (ops/kernels/flash_attention.py fused_q_tile)
    static constexpr int BQ = 64;
    static constexpr int STAGES = DT > 64 ? 2 : 3;
    // P and dS of a q-tile, [64 queries][128 keys] as the two warpgroups'
    // boxes of 64 keys (128-byte swizzled rows): P one tile (a warpgroup
    // reads only its own box), dS two used in turns (the dQ share reads
    // both boxes)
    static constexpr int BOX = BQ * 128;
    static constexpr int PS_TILE = 2 * BOX;
    // the dQ share: DQ_WGS consumer warpgroups, each the [64, DQ_N]
    // fragment of columns DQ_N * wg.. (NF fp32 a thread); SHARE bytes,
    // staged in SUMS tiles used in turns (two where they fit)
    static constexpr int DQ_WGS = DT == 32 ? 1 : 2;
    static constexpr int DQ_N = DT / DQ_WGS;
    static constexpr int NF = DQ_N / 2;
    static constexpr int SHARE = BQ * DT * 4;
    static_assert(DQ_WGS * 128 * NF * 4 == SHARE, "the share covers the q-tile's padded rows");
    static constexpr int K_BYTES = HALVES * FU_BK * ROWB;   // one of K, V
    static constexpr int T_BYTES = HALVES * BQ * ROWB;      // one of Q, dO
    static constexpr int TILE_OFF = 2 * K_BYTES;            // stage s: Q, then dO
    static constexpr int P_OFF = TILE_OFF + STAGES * 2 * T_BYTES;
    static constexpr int DS_OFF = P_OFF + PS_TILE;
    static constexpr int SUM_OFF = DS_OFF + 2 * PS_TILE;
    // lse and delta a stage, the barriers, the alignment slack
    static constexpr int REST = STAGES * 2 * BQ * 4 + 8 * (1 + 2 * STAGES + 5) + 1024;
    static constexpr int SUMS = SUM_OFF + 2 * SHARE + REST <= 232448 ? 2 : 1;
    static constexpr int STAT_OFF = SUM_OFF + SUMS * SHARE;  // stage s: lse, then delta
    static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
    static constexpr int SMEM = STAT_OFF + REST;
    static_assert(SMEM <= 232448, "one CTA's shared memory on the H100");
};

// x, through an asm the compiler keeps in order among the other asm
// statements: what is computed from it is computed where it is used, not
// hoisted out of the q-tile loop and held in registers across it
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
    return x;
}

// A CTA's place in the grid and its walk of q-tiles, from its block
// index.  The grid is one dimension in dispatch groups of p.group (b, h)
// pairs, key tile by key tile within a group: a key tile's predecessors of
// the same (b, h) always come earlier.  Each role builds it anew after the
// branch on the role, from a block index the compiler cannot see through
// (opaque), so that nothing computed before the branch stays live into a
// role's register budget (the producer's 40 spilled it otherwise).
template <int BQ, bool BANDED>
struct Place {
    int kt, b, h, k0, klim, off, win, qstart, nq;
    long long tile0;                    // the (b, h)'s first q-tile among all

    __device__ __forceinline__ Place(const FusedParams& p, int block) {
        const int per_group = p.group * p.nkt;
        const int g = block / per_group;
        const int in_group = block % per_group;
        const int gsize = min(p.group, gridDim.x / p.nkt - g * p.group);
        kt = in_group / gsize;
        const int bh = g * p.group + in_group % gsize;
        h = bh % p.H;
        b = bh / p.H;
        k0 = kt * FU_BK;
        klim = p.kv_lens != nullptr ? min(p.Sk, max(1, p.kv_lens[b])) : p.Sk;
        off = p.Sk - p.Sq;
        win = BANDED ? p.window : 0;
        // the q-tiles [qstart, qend) of flash_bwd_dkv_tc's walk
        qstart = ((p.causal ? max(0, k0 - off) : 0) / BQ) * BQ;
        const int qend = BANDED ? min(p.Sq, max(0, k0 + FU_BK - 1 - off + win)) : p.Sq;
        nq = qstart < qend ? (qend - qstart + BQ - 1) / BQ : 0;
        tile0 = (long long)bh * ((p.Sq + BQ - 1) / BQ);
    }

    // q-tile i of the walk, which goes down the q-tiles from the last: a
    // key tile that starts after its predecessor (the dispatch groups see
    // to it) then finds it ahead on every q-tile, and the sum so far still
    // in L2
    __device__ __forceinline__ int q0(int i) const { return qstart + (nq - 1 - i) * BQ; }

    // the (b, h) slice of a [B, S, H, D] gradient
    template <typename T>
    __device__ __forceinline__ T* slice(void* base, long long sb, long long sh) const {
        return static_cast<T*>(base) + b * sb + h * sh;
    }
};

// P and dS of a warpgroup's 64 keys for one q-tile, from S = Q.K^T and
// dP = dO.V^T in the accumulator's layout (query rows, key columns):
// P = exp(S scale - lse), 0 where vis says no (MASKED; a select, never
// -inf arithmetic: rows with no key have lse = -inf), dS = P (dP - delta)
// scale from the unrounded P, both rounded to T into [64 queries][64 keys]
// boxes of 128-byte swizzled rows (p_box, ds_box).  lse2, dlt: the
// thread's two rows' lse times log2 e and delta.
template <typename T, bool MASKED, typename Vis>
__device__ __forceinline__ void stage_p_ds(const float (&sc)[32], const float (&dp)[32], const float (&lse2)[2],
                                           const float (&dlt)[2], float scale2, float scale, const hopper::Frag& fr,
                                           const Vis& vis, uint32_t p_box, uint32_t ds_box) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r;
            const int c = 8 * j + fr.col;
            float p0 = hopper::ex2(fmaf(sc[e], scale2, -lse2[r]));
            float p1 = hopper::ex2(fmaf(sc[e + 1], scale2, -lse2[r]));
            if (MASKED) {
                p0 = vis(r, c) ? p0 : 0.f;
                p1 = vis(r, c + 1) ? p1 : 0.f;
            }
            const uint32_t o = hopper::swizzled<128>(fr.row + 8 * r, j) + 2 * fr.col;
            hopper::st_shared_u32(p_box + o, hopper::pack2<T>(p0, p1));
            hopper::st_shared_u32(ds_box + o, hopper::pack2<T>(p0 * (dp[e] - dlt[r]) * scale,
                                                               p1 * (dp[e + 1] - dlt[r]) * scale));
        }
}

// BANDED: causal with a window (built apart, so that the causal kernel
// keeps its loop: both consumer warpgroups on every q-tile to the end)
template <typename T, int D, bool BANDED>
__global__ void __launch_bounds__(FU_THREADS, 1) flash_bwd_fused_tc(const __grid_constant__ FusedParams p) {
    using C = FusedCfg<D>;
    using Bx = attn_tc::Boxes<D>;
    constexpr int BQ = C::BQ;
    extern __shared__ uint8_t smem_raw[];
    // aligned by an offset into the shared array (not through an integer),
    // so that the compiler keeps reads of it in the shared address space
    uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = kv_bar + 1;
    uint64_t* empty = full + C::STAGES;
    uint64_t* sum_full = empty + C::STAGES;    // per staging tile: the consumers wrote the share
    uint64_t* sum_empty = sum_full + 2;        // per staging tile: the sum has read it
    uint64_t* sum_in = sum_empty + 2;          // the whole sum has landed (a last contributor)

    {
        const Place<BQ, BANDED> w(p, blockIdx.x);
        if (w.kt == 0)
            zero_unwalked<T, D, FU_BK, BQ>(w.template slice<T>(p.dq, p.dq_sb, p.dq_sh), p.dq_ss, p.Sq, w.klim, w.off,
                                          p.causal, w.win);
        if (w.k0 >= w.klim) {
            // padding keys only: dK = dV = 0, nothing loaded, no dQ share
            T* dkp = w.template slice<T>(p.dk, p.dk_sb, p.dk_sh);
            T* dvp = w.template slice<T>(p.dv, p.dv_sb, p.dv_sh);
            const int rows = min(FU_BK, p.Sk - w.k0);
            for (int id = threadIdx.x; id < rows * D; id += FU_THREADS) {
                const long long r = w.k0 + id / D;
                dkp[r * p.dk_ss + id % D] = from_float<T>(0.f);
                dvp[r * p.dv_ss + id % D] = from_float<T>(0.f);
            }
            return;
        }
    }
    const uint32_t k_all = hopper::smem_u32(smem);          // K's 128 keys
    const uint32_t ds_all = hopper::smem_u32(smem + C::DS_OFF);

    if (threadIdx.x == 0) {
        hopper::mbar_init(kv_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 32);      // the producer warp's lanes
            hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
        }
        for (int s = 0; s < C::SUMS; ++s) {
            hopper::mbar_init(&sum_full[s], C::DQ_WGS * 128);   // every thread that holds a share
            hopper::mbar_init(&sum_empty[s], 1);
        }
        hopper::mbar_init(sum_in, 1);
        hopper::fence_barrier_init();
    }
    __syncthreads();

    // the role, warp-uniform as the compiler sees it (CUTLASS's
    // canonical_warp_group_idx); the two branches never meet again
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == 2) {
        hopper::setmaxnreg_dec<PRODUCER_REGS>();
        const Place<BQ, BANDED> w(p, opaque(blockIdx.x));
        const int nq = w.nq, kt = w.kt, b = w.b, h = w.h, k0 = w.k0;
        auto walk = [=](int i) { return w.q0(i); };
        if (nq == 0) return;
        const int pt = threadIdx.x - 256;
        const int lane = pt % 32;
        if (pt < 32) {
            // warp 0: K and V once, then the walk's q-tiles into the ring
            // (lane 0 the TMA loads, every lane the q-tile's lse and
            // delta, zeros past Sq), STAGES q-tiles ahead of the consumers
            if (lane == 0) {
                hopper::mbar_expect_tx(kv_bar, 2 * C::K_BYTES);
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(smem + hf * FU_BK * C::ROWB, &p.k, kv_bar, hf * 64, h, k0, b);
                    hopper::tma_load_4d(smem + C::K_BYTES + hf * FU_BK * C::ROWB, &p.v, kv_bar, hf * 64, h, k0,
                                        b);
                }
            }
            const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
            const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
            for (int i = 0; i < nq; ++i) {
                const int s = i % C::STAGES;
                const int q0 = walk(i);
                float stat[4];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int q = q0 + lane + 32 * j;
                    stat[j] = q < p.Sq ? lse[q] * hopper::LOG2E : 0.f;
                    stat[2 + j] = q < p.Sq ? delta[q] : 0.f;
                }
                hopper::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
                float* sts = reinterpret_cast<float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
#pragma unroll
                for (int j = 0; j < 4; ++j) sts[(j >> 1) * BQ + lane + 32 * (j & 1)] = stat[j];
                if (lane == 0) {
                    hopper::mbar_expect_tx(&full[s], 2 * C::T_BYTES);
                    uint8_t* qs = smem + C::TILE_OFF + s * 2 * C::T_BYTES;
                    for (int hf = 0; hf < C::HALVES; ++hf) {
                        hopper::tma_load_4d(qs + hf * BQ * C::ROWB, &p.q, &full[s], hf * 64, h, q0, b);
                        hopper::tma_load_4d(qs + C::T_BYTES + hf * BQ * C::ROWB, &p.dout, &full[s], hf * 64, h,
                                            q0, b);
                    }
                } else {
                    hopper::mbar_arrive(&full[s]);
                }
            }
            return;
        }
        // warps 1-3: each q-tile's staged share into the sum, in key order
        // (contributors()); lane 0 of warp 1 (st 0) waits for the turn and
        // runs the bulk copies, all three write dq of a last contributor.
        // They meet at a named barrier on every q-tile, and the staging
        // tile is freed only after it: a thread that fell two phases of
        // sum_full behind (its parity seen again, incomplete) would wait
        // for a share the consumers stage only after the tile is freed.
        const int st = pt - 32;
        long long waited = 0;
        int landed = 0;                           // parity of sum_in's next landing
        int staged = 0;                           // the shares staged so far
        for (int i = 0; i < nq; ++i) {
            const int q0 = walk(i);
            const int2 c = contributors<BQ>(q0, w.klim, w.off, p.causal, w.win, FU_BK);
            const int rank = kt - c.x;
            if (static_cast<unsigned>(rank) >= static_cast<unsigned>(c.y)) __trap();
            if (c.y == 1) continue;               // the consumers wrote dq
            const int slot = staged % C::SUMS;
            const int phase = (staged / C::SUMS) & 1;
            ++staged;
            const bool last = rank == c.y - 1;
            int* cnt = p.ws.counters + w.tile0 + q0 / BQ;
            float* acc = p.ws.acc + (w.tile0 + q0 / BQ) * (BQ * C::DT);
            uint8_t* share = smem + C::SUM_OFF + slot * C::SHARE;
            hopper::mbar_wait(&sum_full[slot], phase);
            if (st == 0 && rank > 0) {
                waited += wait_turn(cnt, rank);
                hopper::fence_proxy_async_global();
            }
            if (!last) {
                if (st == 0) {
                    if (rank == 0)
                        hopper::bulk_store(acc, share, C::SHARE);
                    else
                        hopper::bulk_reduce_add(acc, share, C::SHARE);
                    hopper::bulk_commit();
                    hopper::bulk_wait_read();
                }
                hopper::named_sync(BAR_SUM, SUM_THREADS);
                if (st == 0) {
                    hopper::mbar_arrive(&sum_empty[slot]);
                    hopper::bulk_wait();
                    hopper::fence_proxy_async_global();
                    st_release(cnt, rank + 1);
                }
                continue;
            }
            // the last: the share added in L2, then the whole sum back into
            // its staging tile
            if (st == 0) {
                hopper::bulk_reduce_add(acc, share, C::SHARE);
                hopper::bulk_commit();
                hopper::bulk_wait();
                hopper::fence_proxy_async_global();
                hopper::mbar_expect_tx(sum_in, C::SHARE);
                hopper::bulk_load(share, acc, C::SHARE, sum_in);
            }
            hopper::mbar_wait(sum_in, landed);
            landed ^= 1;
            // the sum, in the fragments' layout: vector id is thread id %
            // 128's vector jj of warpgroup w's fragment; .x, .y: query
            // row, columns col and col + 1, .z, .w: row + 8
            const float4* sum = reinterpret_cast<const float4*>(share);
            for (int id = st; id < C::SHARE / 16; id += SUM_THREADS) {
                const float4 x = sum[id];
                const hopper::Frag fr(id % 128);
                const int jj = id / 128 % (C::NF / 4);
                const int col = id / (128 * (C::NF / 4)) * C::DQ_N + 8 * jj + fr.col;
                const int q = q0 + fr.row;
                if (col < D) {
                    T* row = w.template slice<T>(p.dq, p.dq_sb, p.dq_sh) + (long long)q * p.dq_ss + col;
                    if (q < p.Sq) *reinterpret_cast<uint32_t*>(row) = hopper::pack2<T>(x.x, x.y);
                    if (q + 8 < p.Sq) *reinterpret_cast<uint32_t*>(row + 8 * p.dq_ss) = hopper::pack2<T>(x.z, x.w);
                }
            }
            hopper::named_sync(BAR_SUM, SUM_THREADS);
            if (st == 0) {
                *cnt = 0;
                hopper::mbar_arrive(&sum_empty[slot]);
            }
        }
        if (p.ws.wait_cycles != nullptr && st == 0 && waited > 0)
            atomicAdd(p.ws.wait_cycles, static_cast<unsigned long long>(waited));
    } else {
        hopper::setmaxnreg_inc<CONSUMER_REGS>();
        const Place<BQ, BANDED> w(p, opaque(blockIdx.x));
        const int nq = w.nq, k0 = w.k0, klim = w.klim, off = w.off, win = w.win, qstart = w.qstart;
        auto walk = [=](int i) { return w.q0(i); };
        // consumer warpgroup wg: keys kw .. kw + 63
        const int t = threadIdx.x % 128;
        const hopper::Frag fr(t);
        const int kw = k0 + 64 * wg;
        attn_tc::DkvAcc<D> acc;
        acc.init();
        const uint32_t k_own = k_all + 64 * wg * C::ROWB;      // this warpgroup's K rows
        // the B operand of this warpgroup's dQ share: K's box wg (the
        // tile of 128), half wg of the box (D 64), the box (D 32)
        const uint32_t k_dq = k_all + (C::DT == 128 ? wg * FU_BK * 128 : C::DT == 64 ? wg * 64 : 0);
        const uint32_t p_own = hopper::smem_u32(smem + C::P_OFF) + wg * C::BOX;

        // under a band, this warpgroup's own q-tiles, [i_lo, i_hi) of [0, nq)
        // counted up from qstart (flash_bwd_dkv_tc); on the others its dS is 0
        int i_lo = 0, i_hi = nq;
        if constexpr (BANDED) {
            const int last_row = kw + 63 - off + win - 1;
            const int lo = min(nq, max(0, kw - off - qstart) / BQ);
            i_hi = __shfl_sync(0xffffffffu, kw >= klim || last_row < qstart ? lo
                               : max(lo, min(nq, (last_row - qstart) / BQ + 1)), 0);
            i_lo = __shfl_sync(0xffffffffu, lo, 0);
        }
        // the masks' bounds, fixed over the loop: a q-tile below q_diag
        // crosses the diagonal, one with edge set the key length, one at or
        // past q_band the band's lower edge
        const int q_diag = kw + 63 - off;
        const bool edge = kw + 64 > klim;
        const int q_band = kw - off + win - BQ + 1;

        // One q-tile i of the walk.  Active (some key of this warpgroup
        // sees it): S = Q.K^T and dP = dO.V^T over its 64 keys (queries as
        // the M rows, as FlashAttention-3 does: a thread's lse and delta
        // are its two rows'), P and dS rounded into the warpgroup's boxes
        // of the P and dS tiles; idle (under a band): the stage freed once
        // its data has landed (so that the arrival cannot count toward the
        // stage's previous tile), the warpgroup's box of dS zero.  Then,
        // once both warpgroups have staged dS, dV += P^T.dO and dK +=
        // dS^T.Q (active; P^T, dS^T: the boxes read MN-major) and this
        // warpgroup's part of the dQ share in one group, and the share
        // into its staging tile, or into dq where it is the q-tile's only
        // contributor.  (Captures by value but for the accumulators and
        // the count of staged shares: through a captured reference the
        // shared-memory pointers lost their address space, and lse and
        // delta were read with generic loads.)
        int staged = 0;                           // the shares staged so far
        auto tile = [=, &acc, &staged](int i, auto active) {
            constexpr bool ACTIVE = decltype(active)::value;
            const int s = i % C::STAGES;
            const int q0 = walk(i);
            hopper::mbar_wait_no_trap(&full[s], (i / C::STAGES) & 1);
            const uint32_t q_addr = hopper::smem_u32(smem + C::TILE_OFF + s * 2 * C::T_BYTES);
            const uint32_t do_addr = q_addr + C::T_BYTES;
            const uint32_t ds = opaque(ds_all + (i & 1) * C::PS_TILE);
            const uint32_t ds_own = ds + wg * C::BOX;
            if constexpr (ACTIVE) {
                const float* lse_s = reinterpret_cast<const float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
                const uint32_t v_own = k_own + C::K_BYTES;
                float sc[32], dp[32];
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < Bx::KSTEPS; ++kk)
                    hopper::mma_ss<T, 64>(sc, hopper::tile_desc<Bx::ROWB>(q_addr + hopper::kstep<BQ, Bx::ROWB>(kk)),
                                          hopper::tile_desc<Bx::ROWB>(k_own + hopper::kstep<FU_BK, Bx::ROWB>(kk)),
                                          kk > 0);
#pragma unroll
                for (int kk = 0; kk < Bx::KSTEPS; ++kk)
                    hopper::mma_ss<T, 64>(dp, hopper::tile_desc<Bx::ROWB>(do_addr + hopper::kstep<BQ, Bx::ROWB>(kk)),
                                          hopper::tile_desc<Bx::ROWB>(v_own + hopper::kstep<FU_BK, Bx::ROWB>(kk)),
                                          kk > 0);
                hopper::wgmma_commit();
                hopper::wgmma_wait0();
                hopper::fence_regs(sc);
                hopper::fence_regs(dp);

                int qi[2];
                float lse2[2], dlt[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    qi[r] = q0 + fr.row + 8 * r;
                    lse2[r] = lse_s[fr.row + 8 * r];
                    dlt[r] = lse_s[BQ + fr.row + 8 * r];
                }
                const float scale2 = p.scale * hopper::LOG2E;
                if constexpr (BANDED) {
                    // only q-tiles that cross the causal, key-length or band
                    // edge are masked; row r sees keys lo[r] .. hi[r] of the
                    // warpgroup's (rows past Sq have zero Q and dO, lse and
                    // delta: their P feeds dV times dO = 0, their dS is 0)
                    const bool crosses = edge | (q0 < q_diag) | (q0 >= q_band);
                    int lo[2], hi[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        lo[r] = qi[r] + off - win + 1 - kw;
                        hi[r] = min(qi[r] + off, klim - 1) - kw;
                    }
                    auto vis = [=](int r, int c) { return (c >= lo[r]) & (c <= hi[r]); };
                    if (crosses)
                        stage_p_ds<T, true>(sc, dp, lse2, dlt, scale2, p.scale, fr, vis, p_own, ds_own);
                    else
                        stage_p_ds<T, false>(sc, dp, lse2, dlt, scale2, p.scale, fr, vis, p_own, ds_own);
                } else {
                    // only q-tiles that cross the causal, key-length or Sq edge are masked
                    const int Sq = p.Sq;
                    const bool causal = p.causal;
                    const bool crosses = (causal & (q0 < q_diag)) | edge | (q0 + BQ > Sq);
                    auto vis = [=](int r, int c) {
                        const int key = kw + c;
                        return (key < klim) & (qi[r] < Sq) & (!causal | (key <= qi[r] + off));
                    };
                    if (crosses)
                        stage_p_ds<T, true>(sc, dp, lse2, dlt, scale2, p.scale, fr, vis, p_own, ds_own);
                    else
                        stage_p_ds<T, false>(sc, dp, lse2, dlt, scale2, p.scale, fr, vis, p_own, ds_own);
                }
            } else {
                if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
                for (int o = 16 * t; o < C::BOX; o += 16 * 128)
                    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(ds_own + o), "r"(0) : "memory");
            }
            hopper::fence_proxy_async();
            hopper::named_sync(BAR_CONS, 256);

            // dV += P^T.dO and dK += dS^T.Q (active: A the warpgroup's box
            // MN-major, B dO and Q MN-major), and the dQ share dQ[64
            // queries, DQ_N] = dS.K over the 128 keys (A the dS tile
            // K-major, B this warpgroup's columns of K MN-major)
            float f[C::NF];
            if constexpr (ACTIVE) {
#pragma unroll
                for (int hf = 0; hf < Bx::HALVES; ++hf) {
                    hopper::fence_regs(acc.dv[hf]);
                    hopper::fence_regs(acc.dk[hf]);
                }
            }
            hopper::wgmma_fence();
            if constexpr (ACTIVE) {
#pragma unroll
                for (int hf = 0; hf < Bx::HALVES; ++hf)
#pragma unroll
                    for (int kk = 0; kk < BQ / 16; ++kk)
                        hopper::mma_ss<T, Bx::COLS, 1, 1>(
                            acc.dv[hf], hopper::tile_desc<128>(p_own + kk * 16 * 128),
                            hopper::tile_desc<Bx::ROWB>(do_addr + hf * BQ * Bx::ROWB + kk * 16 * Bx::ROWB), 1);
#pragma unroll
                for (int hf = 0; hf < Bx::HALVES; ++hf)
#pragma unroll
                    for (int kk = 0; kk < BQ / 16; ++kk)
                        hopper::mma_ss<T, Bx::COLS, 1, 1>(
                            acc.dk[hf], hopper::tile_desc<128>(ds_own + kk * 16 * 128),
                            hopper::tile_desc<Bx::ROWB>(q_addr + hf * BQ * Bx::ROWB + kk * 16 * Bx::ROWB), 1);
            }
            const bool shares = C::DQ_WGS == 2 || wg == 0;
            if (shares) {
#pragma unroll
                for (int kk = 0; kk < FU_BK / 16; ++kk)
                    hopper::mma_ss<T, C::DQ_N, 0, 1>(f, hopper::tile_desc<128>(ds + hopper::kstep<BQ, 128>(kk)),
                                                     hopper::tile_desc<Bx::ROWB>(k_dq + kk * 16 * Bx::ROWB), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait0();
            if constexpr (ACTIVE) {
#pragma unroll
                for (int hf = 0; hf < Bx::HALVES; ++hf) {
                    hopper::fence_regs(acc.dv[hf]);
                    hopper::fence_regs(acc.dk[hf]);
                }
                if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
            }
            if (!shares) return;
            hopper::fence_regs(f);
            if (contributors<BQ>(q0, klim, off, p.causal, win, FU_BK).y == 1) {
                // the q-tile's only contributor: the share is dq
                hopper::store_frag<T, C::DQ_N>(f, w.template slice<T>(p.dq, p.dq_sb, p.dq_sh), p.dq_ss, q0,
                                               wg * C::DQ_N, p.Sq, 1.f, 1.f, fr, D - wg * C::DQ_N);
                return;
            }
            {
                const int slot = staged % C::SUMS;
                hopper::mbar_wait_no_trap(&sum_empty[slot], ((staged / C::SUMS) & 1) ^ 1);
                ++staged;
                float4* dst = reinterpret_cast<float4*>(smem + C::SUM_OFF + slot * C::SHARE) +
                              wg * (C::NF / 4) * 128 + t;
#pragma unroll
                for (int jj = 0; jj < C::NF / 4; ++jj)
                    dst[jj * 128] = make_float4(f[4 * jj], f[4 * jj + 1], f[4 * jj + 2], f[4 * jj + 3]);
                hopper::fence_proxy_async();
                hopper::mbar_arrive(&sum_full[slot]);
            }
        };

        if (nq > 0) hopper::mbar_wait_no_trap(kv_bar, 0);
        if constexpr (BANDED) {
            // the walk's index i is q-tile nq - 1 - i counted up
            for (int i = 0; i < nq - i_hi; ++i) tile(i, std::false_type());
            for (int i = nq - i_hi; i < nq - i_lo; ++i) tile(i, std::true_type());
            for (int i = nq - i_lo; i < nq; ++i) tile(i, std::false_type());
        } else {
            for (int i = 0; i < nq; ++i) tile(i, std::true_type());
        }
        attn_tc::dkv_finish<T, D>(acc, fr, w.template slice<T>(p.dk, p.dk_sb, p.dk_sh), p.dk_ss,
                                  w.template slice<T>(p.dv, p.dv_sb, p.dv_sh), p.dv_ss, kw, p.Sk);
    }
}

// The (b, h) pairs of a dispatch group: enough that key tile j of a (b, h)
// is dispatched about HEAD_TILES q-tiles of work after key tile j - 1 (the
// card's SMs each take one CTA: a CTA walks avg q-tiles, so the SMs finish
// about sm_count / avg CTAs per q-tile of time), few enough that the sum
// so far is reused from L2
template <int BQ>
int dispatch_group(const BwdArgs& a, int nkt) {
    constexpr int HEAD_TILES = 2;
    const int off = a.Sk - a.Sq;
    long long walks = 0;
    for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * FU_BK;
        const int qstart = ((a.causal ? max(0, k0 - off) : 0) / BQ) * BQ;
        const int qend = banded(a) ? min(a.Sq, max(0, k0 + FU_BK - 1 - off + a.window)) : a.Sq;
        walks += qstart < qend ? (qend - qstart + BQ - 1) / BQ : 0;
    }
    const double avg = std::max(1.0, double(walks) / nkt);
    return std::max(1, std::min(a.B * a.H, int(HEAD_TILES * sm_count() / avg + 0.5)));
}

template <typename T, int D, bool BANDED>
cudaError_t launch_fused_tc(const BwdArgs& a, const FusedWs& ws, int dtype, cudaStream_t stream) {
    using C = FusedCfg<D>;
    FusedParams p{};
    cudaError_t err = cudaSuccess;
    // with no keys every CTA is padding, with no queries nothing but K and
    // V would be loaded: the maps are left out
    if (a.Sk > 0 && a.Sq > 0) {
        err = hopper::map_rows(&p.k, a.k, dtype, a.B, a.Sk, a.H, D, a.k_sb, a.k_ss, a.k_sh, FU_BK);
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.v, a.v, dtype, a.B, a.Sk, a.H, D, a.v_sb, a.v_ss, a.v_sh, FU_BK);
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.q, a.q, dtype, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, a.q_sh, C::BQ);
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.dout, a.dout, dtype, a.B, a.Sq, a.H, D, a.do_sb, a.do_ss, a.do_sh, C::BQ);
    }
    if (err != cudaSuccess) return err;
    p.lse = a.lse; p.delta = a.delta;
    p.dq = a.dq; p.dk = a.dk; p.dv = a.dv; p.ws = ws; p.kv_lens = a.kv_lens;
    p.Sq = a.Sq; p.Sk = a.Sk; p.H = a.H;
    p.nkt = max(1, (a.Sk + FU_BK - 1) / FU_BK);
    p.group = dispatch_group<C::BQ>(a, p.nkt);
    p.dq_sb = a.dq_sb; p.dq_ss = a.dq_ss; p.dq_sh = a.dq_sh;
    p.dk_sb = a.dk_sb; p.dk_ss = a.dk_ss; p.dk_sh = a.dk_sh;
    p.dv_sb = a.dv_sb; p.dv_ss = a.dv_ss; p.dv_sh = a.dv_sh;
    p.scale = a.scale; p.causal = a.causal; p.window = a.window;
    static const cudaError_t attr = cudaFuncSetAttribute(flash_bwd_fused_tc<T, D, BANDED>,
                                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    flash_bwd_fused_tc<T, D, BANDED><<<a.B * a.H * p.nkt, FU_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}


template <typename T, int D>
cudaError_t launch_fused_tc(const BwdArgs& a, const FusedWs& ws, int dtype, cudaStream_t stream) {
    return banded(a) ? launch_fused_tc<T, D, true>(a, ws, dtype, stream)
                     : launch_fused_tc<T, D, false>(a, ws, dtype, stream);
}

}  // namespace

// acc: fp32, B * H * ceil(Sq / BQ) * BQ * tile_dim(D) (BQ: FusedCfg's 64
// for bf16 and fp16, FmaTile's for fp32: 64 at D <= 64, 32 above);
// counters: int32, B * H * ceil(Sq / BQ), zero before the first
// launch (each launch leaves them zero); wait_cycles: null, or one
// uint64 the CTAs' waiting cycles are added to.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* kv_lens,
                               void* dq, void* dk, void* dv, float* acc, int* counters,
                               unsigned long long* wait_cycles, int dtype, int B, int Sq, int Sk, int H, int D,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long do_sb, long long do_ss, long long do_sh,
                               long long dq_sb, long long dq_ss, long long dq_sh,
                               long long dk_sb, long long dk_ss, long long dk_sh,
                               long long dv_sb, long long dv_ss, long long dv_sh,
                               float scale, int causal, int window, void* stream_ptr) {
    if (B == 0 || H == 0 || (Sq == 0 && Sk == 0)) return 0;
    BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
              dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, causal, kv_lens, window};
    const FusedWs ws{acc, counters, wait_cycles};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define DS_FUSED_D(T, LAUNCH, ...)                                      \
    switch (D) {                                                         \
        case 32: return static_cast<int>(LAUNCH<T, 32>(a, ws, ##__VA_ARGS__, stream));   \
        case 64: return static_cast<int>(LAUNCH<T, 64>(a, ws, ##__VA_ARGS__, stream));   \
        case 80: return static_cast<int>(LAUNCH<T, 80>(a, ws, ##__VA_ARGS__, stream));   \
        case 96: return static_cast<int>(LAUNCH<T, 96>(a, ws, ##__VA_ARGS__, stream));   \
        case 128: return static_cast<int>(LAUNCH<T, 128>(a, ws, ##__VA_ARGS__, stream)); \
        default: return static_cast<int>(cudaErrorInvalidValue);        \
    }
    switch (dtype) {
        case kF32: DS_FUSED_D(float, launch_fused_fma)
        case kF16: DS_FUSED_D(__half, launch_fused_tc, dtype)
        case kBF16: DS_FUSED_D(__nv_bfloat16, launch_fused_tc, dtype)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DS_FUSED_D
}
