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
// traffic (a write, and a read per contributor after the first) is the
// design's cost and outside the bound.
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
// bf16 and fp16 (flash_bwd_fused_tc): flash_bwd_dkv_tc's sweep (a CTA per
// (b, h, 128 keys), q-tiles of Q and dO through a TMA ring, K and V loaded
// once) with a third warpgroup.  The two consumer warpgroups do what
// flash_bwd_dkv_tc's do (S^T, dP^T, P^T and dS^T over their 64 keys, dV
// and dK on wgmma) and also write dS^T into a shared tile of the CTA's 128
// keys (two, used in turns, so they run up to two q-tiles ahead).  The
// producer warpgroup's first warp keeps the ring loaded; all four of its
// warps compute each q-tile's dQ share over the 128 keys from that tile,
// both operands MN-major in shared memory:
//   D 64, 128: dQ^T = K^T.dS^T (M = D: K's box, two at D 128)
//   D 32:      dQ = dS.K       (M = the 64 queries)
// and add it to the running sum: one bulk copy brings the sum so far in as
// soon as the CTA's turn has come (a q-tile ahead where it already has),
// and the share stays in the wgmma fragment's layout, as the accumulator
// does (each thread's values at 16-byte vectors of their own), so only the
// last contributor maps it to dq's rows.  The consumers never wait on the
// sum; the dQ work overlaps their dK and dV work.
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
// [BQ, DT] per q-tile either way.
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
constexpr int BAR_SUM = 3;              // named barrier of the producer warpgroup

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
    static constexpr int BQ = D > 64 ? 32 : 64;             // queries per q-tile
    static constexpr int STAGES = D > 64 ? 2 : 3;
    // the CTA's dS^T of a q-tile: [128 keys][BQ queries], DS_ROWB-byte rows,
    // two buffers used in turns
    static constexpr int DS_ROWB = 2 * BQ;
    static constexpr int DS_TILE = FU_BK * DS_ROWB;
    // the CTA's dQ share of a q-tile: NM wgmma fragments of 64 rows by
    // 2 NF columns (NF fp32 a thread of the producer warpgroup), NIDX
    // float4 in the accumulator (the tile of 128: the two halves of it)
    static constexpr int DT = attn_tc::Boxes<D>::DT;
    static constexpr int NM = DT == 128 ? 2 : 1;
    static constexpr int NF = DT == 64 ? 32 : 16;
    static constexpr int NIDX = NM * NF * 32;
    static constexpr int K_BYTES = HALVES * FU_BK * ROWB;   // one of K, V
    static constexpr int T_BYTES = HALVES * BQ * ROWB;      // one of Q, dO
    static constexpr int TILE_OFF = 2 * K_BYTES;            // stage s: Q, then dO
    static constexpr int DS_OFF = TILE_OFF + STAGES * 2 * T_BYTES;
    static constexpr int ACC_OFF = DS_OFF + 2 * DS_TILE;    // two sums so far
    static constexpr int STAT_OFF = ACC_OFF + 2 * NIDX * 16;   // stage s: lse, then delta
    static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES + 6) + 1024;   // + alignment slack
    static_assert(NIDX * 4 == BQ * DT, "the share covers the q-tile's padded rows");
};

// x, through an asm the compiler keeps in order among the other asm
// statements: what is computed from it is computed where it is used, not
// hoisted out of the q-tile loop and held in registers across it
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
    return x;
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
    uint64_t* staged_full = empty + C::STAGES;    // per buffer: the consumers wrote dS^T
    uint64_t* staged_empty = staged_full + 2;     // per buffer: the dQ share was computed from it
    uint64_t* acc_bar = staged_empty + 2;         // per buffer: the sum so far has landed
    float4* acc_s = reinterpret_cast<float4*>(smem + C::ACC_OFF);

    // the grid is one dimension in dispatch groups of p.group (b, h)
    // pairs, key tile by key tile within a group: a key tile's
    // predecessors of the same (b, h) always come earlier
    const int per_group = p.group * p.nkt;
    const int g = blockIdx.x / per_group;
    const int in_group = blockIdx.x % per_group;
    const int gsize = min(p.group, gridDim.x / p.nkt - g * p.group);
    const int kt = in_group / gsize;
    const int bh = g * p.group + in_group % gsize;
    const int h = bh % p.H;
    const int b = bh / p.H;
    const int k0 = kt * FU_BK;
    const int klim = p.kv_lens != nullptr ? min(p.Sk, max(1, p.kv_lens[b])) : p.Sk;
    const int off = p.Sk - p.Sq;
    const int win = BANDED ? p.window : 0;
    T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
    T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
    if (kt == 0) zero_unwalked<T, D, FU_BK, BQ>(dqp, p.dq_ss, p.Sq, klim, off, p.causal, win);
    if (k0 >= klim) {
        // padding keys only: dK = dV = 0, nothing loaded, no dQ share
        const int rows = min(FU_BK, p.Sk - k0);
        for (int id = threadIdx.x; id < rows * D; id += FU_THREADS) {
            const long long r = k0 + id / D;
            dkp[r * p.dk_ss + id % D] = from_float<T>(0.f);
            dvp[r * p.dv_ss + id % D] = from_float<T>(0.f);
        }
        return;
    }
    // the q-tiles [qstart, qend) of flash_bwd_dkv_tc's walk
    const int qstart = ((p.causal ? max(0, k0 - off) : 0) / BQ) * BQ;
    const int qend = BANDED ? min(p.Sq, max(0, k0 + FU_BK - 1 - off + win)) : p.Sq;
    const int nq = qstart < qend ? (qend - qstart + BQ - 1) / BQ : 0;
    // the walk goes down the q-tiles, from the last: a key tile that starts
    // after its predecessor (the dispatch groups see to it) then finds it
    // ahead on every q-tile, and the sum so far still in L2
    auto walk = [=](int i) { return qstart + (nq - 1 - i) * BQ; };
    const long long tile0 = (long long)bh * ((p.Sq + BQ - 1) / BQ);   // the (b, h)'s first q-tile
    const uint32_t k_all = hopper::smem_u32(smem);          // K's 128 keys
    const uint32_t ds_all = hopper::smem_u32(smem + C::DS_OFF);

    if (threadIdx.x == 0) {
        hopper::mbar_init(kv_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 32);      // the producer warp's lanes
            hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
        }
        for (int s = 0; s < 2; ++s) {
            hopper::mbar_init(&staged_full[s], 256);   // every consumer thread
            hopper::mbar_init(&staged_empty[s], 4);    // one arrival per producer warp
            hopper::mbar_init(&acc_bar[s], 1);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // The producer warpgroup.  Its first warp loads, as
        // flash_bwd_dkv_tc's producer warp (lane 0 the TMA loads, every
        // lane the q-tile's lse and delta, zeros past Sq), up to STAGES
        // q-tiles ahead of the dQ share it computes next (so a wait for a
        // free stage never waits on a share not yet computed).  All four
        // warps compute each q-tile's dQ share over the CTA's 128 keys from
        // the staged dS^T, then add it in key order to the sum so far
        // (contributors()), which one bulk copy brings in as soon as this
        // CTA's turn has come, a q-tile ahead where it has already come;
        // the last contributor writes dq instead.
        if (nq == 0) return;
        const int pt = threadIdx.x - 256;
        const int pw = pt / 32;
        const int lane = pt % 32;
        constexpr int PER_LANE = BQ / 32;
        const long long stat0 = ((long long)b * p.H + h) * p.Sq;
        float lse_r[PER_LANE], delta_r[PER_LANE];
        auto stats = [&](int q0) {
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int q = q0 + lane + 32 * j;
                const bool ok = q < p.Sq;
                lse_r[j] = ok ? p.lse[stat0 + q] * hopper::LOG2E : 0.f;
                delta_r[j] = ok ? p.delta[stat0 + q] : 0.f;
            }
        };
        int loaded = 0;                           // the q-tiles of the walk loaded so far
        // warp 0: the walk's q-tiles [loaded, upto) into the ring
        auto load_upto = [&](int upto) {
            for (; loaded < min(nq, upto); ++loaded) {
                const int i = loaded;
                const int s = i % C::STAGES;
                const int q0 = walk(i);
                hopper::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
                float* st = reinterpret_cast<float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
#pragma unroll
                for (int j = 0; j < PER_LANE; ++j) {
                    st[lane + 32 * j] = lse_r[j];
                    st[BQ + lane + 32 * j] = delta_r[j];
                }
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
                if (i + 1 < nq) stats(walk(i + 1));
            }
        };
        if (pw == 0) {
            if (lane == 0) {
                hopper::mbar_expect_tx(kv_bar, 2 * C::K_BYTES);
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(smem + hf * FU_BK * C::ROWB, &p.k, kv_bar, hf * 64, h, k0, b);
                    hopper::tma_load_4d(smem + C::K_BYTES + hf * FU_BK * C::ROWB, &p.v, kv_bar, hf * 64, h, k0,
                                        b);
                }
            }
            stats(walk(0));
            load_upto(C::STAGES);
        }
        hopper::mbar_wait(kv_bar, 0);

        const hopper::Frag fr(pt);
        long long waited = 0;
        // q-tile i of the walk: its place in the order (rank, count)
        auto order = [&](int i) {
            const int2 c = contributors<BQ>(walk(i), klim, off, p.causal, win, FU_BK);
            const int rank = kt - c.x;
            if (static_cast<unsigned>(rank) >= static_cast<unsigned>(c.y)) __trap();
            return make_int2(rank, c.y);
        };
        // warp 1's lane 0: the sum so far of q-tile i into buffer i & 1
        // once the turn has come (with `wait`; else only if it has come)
        int fetched = 0;                          // bit b: buffer b's sum so far is requested
        auto fetch = [&](int i, bool wait) {
            const int rank = order(i).x;
            int* cnt = p.ws.counters + tile0 + walk(i) / BQ;
            if (rank == 0 || (fetched >> (i & 1) & 1) || (!wait && ld_acquire(cnt) != rank)) return;
            if (wait) waited += wait_turn(cnt, rank);
            hopper::fence_proxy_async_global();
            hopper::mbar_expect_tx(&acc_bar[i & 1], C::NIDX * 16);
            hopper::bulk_load(acc_s + (i & 1) * C::NIDX,
                              reinterpret_cast<float4*>(p.ws.acc) + (tile0 + walk(i) / BQ) * C::NIDX,
                              C::NIDX * 16, &acc_bar[i & 1]);
            fetched |= 1 << (i & 1);
        };
        int loads = 0;                            // bit b: parity of buffer b's next landing
        for (int i = 0; i < nq; ++i) {
            const int slot = i & 1;
            const int q0 = walk(i);
            if (pw == 0) load_upto(i + C::STAGES);
            if (pt == 32) {
                fetch(i, true);
                if (i + 1 < nq) fetch(i + 1, false);
            }
            // the share from the staged dS^T, both operands MN-major:
            //   D 32:      dQ = dS.K (A: dS^T [keys][64 queries], B: K [keys][32])
            //   D 64 up:   dQ^T = K^T.dS^T (A: K's box m, B: dS^T [keys][BQ])
            const uint32_t ds = ds_all + slot * C::DS_TILE;
            hopper::mbar_wait(&staged_full[slot], (i >> 1) & 1);
            float f[C::NM][C::NF];
            hopper::wgmma_fence();
#pragma unroll
            for (int m = 0; m < C::NM; ++m)
#pragma unroll
                for (int kk = 0; kk < FU_BK / 16; ++kk) {
                    if constexpr (D == 32)
                        hopper::mma_ss_tt<T, 2 * C::NF>(f[m], hopper::tile_desc<128>(ds + kk * 16 * 128),
                                                        hopper::tile_desc<64>(k_all + kk * 16 * 64), kk > 0);
                    else
                        hopper::mma_ss_tt<T, 2 * C::NF>(
                            f[m], hopper::tile_desc<128>(k_all + m * FU_BK * 128 + kk * 16 * 128),
                            hopper::tile_desc<C::DS_ROWB>(ds + kk * 16 * C::DS_ROWB), kk > 0);
                }
            hopper::wgmma_commit();
            hopper::wgmma_wait0();
#pragma unroll
            for (int m = 0; m < C::NM; ++m) hopper::fence_regs(f[m]);
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&staged_empty[slot]);

            const int2 c = order(i);
            const int rank = c.x;
            const bool last = rank == c.y - 1;
            int* cnt = p.ws.counters + tile0 + q0 / BQ;
            float4* acc = reinterpret_cast<float4*>(p.ws.acc) + (tile0 + q0 / BQ) * C::NIDX;
            const float4* acc_i = acc_s + slot * C::NIDX;
            if (rank > 0) {
                hopper::mbar_wait(&acc_bar[slot], loads >> slot & 1);
                loads ^= 1 << slot;
            }
            // this thread's vector jj of fragment m, at (m * NF / 4 + jj) *
            // 128 + pt: the sum so far added to the share.  The dq path is
            // a loop of its own (one loop with both spilled at D 64).
            auto vec = [&](int m, int jj) {
                float4 x = make_float4(f[m][4 * jj], f[m][4 * jj + 1], f[m][4 * jj + 2], f[m][4 * jj + 3]);
                if (rank > 0) {
                    const float4 y = acc_i[(m * (C::NF / 4) + jj) * 128 + pt];
                    x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
                }
                return x;
            };
            if (!last) {
#pragma unroll
                for (int m = 0; m < C::NM; ++m)
#pragma unroll
                    for (int jj = 0; jj < C::NF / 4; ++jj) __stcg(acc + (m * (C::NF / 4) + jj) * 128 + pt, vec(m, jj));
            } else {
#pragma unroll
                for (int m = 0; m < C::NM; ++m)
#pragma unroll
                    for (int jj = 0; jj < C::NF / 4; ++jj) {
                        // .x, .y: row fr.row, columns 8 jj + fr.col and the
                        // next; .z, .w: row fr.row + 8.  D 32: rows are
                        // queries, columns D; D 64 and up: rows are D (the
                        // tile of 128: m its half; rows past D padding),
                        // columns queries
                        const float4 x = vec(m, jj);
                        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int row = fr.row + 8 * (e >> 1), col = 8 * jj + fr.col + (e & 1);
                            const int q = q0 + (D == 32 ? row : col);
                            const int d = D == 32 ? col : 64 * m + row;
                            if ((q < p.Sq) & (d < D)) dqp[(long long)q * p.dq_ss + d] = from_float<T>(xs[e]);
                        }
                    }
            }
            // the sum so far is read (buffer slot may be fetched into
            // again), the stores made before the release
            hopper::named_sync(BAR_SUM, 128);
            fetched &= ~(1 << slot);
            if (pt == 32) {
                if (!last)
                    st_release(cnt, rank + 1);
                else if (rank > 0)
                    *cnt = 0;
            }
        }
        if (p.ws.wait_cycles != nullptr && pt == 32 && waited > 0)
            atomicAdd(p.ws.wait_cycles, static_cast<unsigned long long>(waited));
        return;
    }

    // consumer warpgroup wg: keys kw .. kw + 63
    const int t = threadIdx.x % 128;
    const hopper::Frag fr(t);
    const int kw = k0 + 64 * wg;
    const int kj[2] = {kw + fr.row, kw + fr.row + 8};
    attn_tc::DkvAcc<D> acc;
    acc.init();
    const uint32_t k_own = k_all + 64 * wg * C::ROWB;      // this warpgroup's K rows

    // under a band, this warpgroup's own q-tiles, [i_lo, i_hi) of [0, nq)
    // counted up from qstart (flash_bwd_dkv_tc); on the others its dS^T is 0
    int i_lo = 0, i_hi = nq;
    if constexpr (BANDED) {
        const int last_row = kw + 63 - off + win - 1;
        const int lo = min(nq, max(0, kw - off - qstart) / BQ);
        i_hi = __shfl_sync(0xffffffffu, kw >= klim || last_row < qstart ? lo
                           : max(lo, min(nq, (last_row - qstart) / BQ + 1)), 0);
        i_lo = __shfl_sync(0xffffffffu, lo, 0);
    }
    // the masks' bounds, fixed over the loop (the consumers run at their
    // register cap): a q-tile below q_diag crosses the diagonal, one with
    // edge set the key length; under a band, as flash_bwd_dkv_tc's
    const int q_diag = kw + 63 - off;
    const bool edge = kw + 64 > klim;
    int a = 0, w[2] = {0, 0}, q_band = 0;
    if constexpr (BANDED) {
        a = kj[0] - off;
#pragma unroll
        for (int r = 0; r < 2; ++r) w[r] = kj[r] < klim ? win : 0;
        q_band = kw - off + win - BQ + 1;
    }

    // one q-tile this warpgroup computes: dkv_step's products, with dS^T
    // staged for the producer warpgroup's dQ share.  (Captures by value but
    // for the accumulators: through a captured reference the shared-memory
    // pointers lost their address space, and lse and delta were read with
    // generic loads.)
    auto active = [=, &acc](int i) {
        const int s = i % C::STAGES;
        const int q0 = walk(i);
        const int Sq = p.Sq;
        const bool causal = p.causal;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        const uint32_t k_addr = k_own;
        const uint32_t v_addr = k_addr + C::K_BYTES;
        const uint32_t q_addr = hopper::smem_u32(smem + C::TILE_OFF + s * 2 * C::T_BYTES);
        const uint32_t do_addr = q_addr + C::T_BYTES;
        const float* lse_s = reinterpret_cast<const float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
        float st[BQ / 2], dpt[BQ / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Bx::KSTEPS; ++kk)
            hopper::mma_ss<T, BQ>(st, hopper::tile_desc<Bx::ROWB>(k_addr + hopper::kstep<FU_BK, Bx::ROWB>(kk)),
                                  hopper::tile_desc<Bx::ROWB>(q_addr + hopper::kstep<BQ, Bx::ROWB>(kk)), kk > 0);
#pragma unroll
        for (int kk = 0; kk < Bx::KSTEPS; ++kk)
            hopper::mma_ss<T, BQ>(dpt, hopper::tile_desc<Bx::ROWB>(v_addr + hopper::kstep<FU_BK, Bx::ROWB>(kk)),
                                  hopper::tile_desc<Bx::ROWB>(do_addr + hopper::kstep<BQ, Bx::ROWB>(kk)), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);

        const float scale2 = p.scale * hopper::LOG2E;
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
        if constexpr (BANDED) {
            // only q-tiles that cross the causal, key-length or band edge
            // are masked (flash_bwd_dkv_tc)
            const bool crosses = edge | (q0 < q_diag) | (q0 >= q_band);
            auto vis = [=](int r, int c) {
                return static_cast<unsigned>(q0 + c - a - 8 * r) < static_cast<unsigned>(w[r]);
            };
            if (crosses)
                attn_tc::dkv_operands<T, BQ, true>(st, dpt, pa, dsa, lse_s, lse_s + BQ, scale2, p.scale, fr, vis);
            else
                attn_tc::dkv_operands<T, BQ, false>(st, dpt, pa, dsa, lse_s, lse_s + BQ, scale2, p.scale, fr, vis);
        } else {
            // only q-tiles that cross the causal, key-length or Sq edge are masked
            const bool crosses = (causal & (q0 < q_diag)) | edge | (q0 + BQ > Sq);
            auto vis = [=](int r, int c) {
                const int key = kj[r];
                const int qi = q0 + c;
                return (key < klim) & (qi < Sq) & (!causal | (key <= qi + off));
            };
            if (crosses)
                attn_tc::dkv_operands<T, BQ, true>(st, dpt, pa, dsa, lse_s, lse_s + BQ, scale2, p.scale, fr, vis);
            else
                attn_tc::dkv_operands<T, BQ, false>(st, dpt, pa, dsa, lse_s, lse_s + BQ, scale2, p.scale, fr, vis);
        }
        // dS^T into this warpgroup's rows of buffer i & 1: dsa[kk][j] holds
        // key fr.row + 8 (j & 1) of the warpgroup's, queries
        // 16 kk + 8 (j >> 1) + fr.col and the next
        hopper::mbar_wait(&staged_empty[i & 1], ((i >> 1) & 1) ^ 1);
        const uint32_t ds = opaque(ds_all + (i & 1) * C::DS_TILE);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = 64 * wg + fr.row + 8 * (j & 1);
                const int q = 16 * kk + 8 * (j >> 1) + fr.col;
                hopper::st_shared_u32(ds + hopper::swizzled<C::DS_ROWB>(key, q / 8) + 2 * fr.col, dsa[kk][j]);
            }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&staged_full[i & 1]);

#pragma unroll
        for (int hf = 0; hf < Bx::HALVES; ++hf) {
            hopper::fence_regs(acc.dv[hf]);
            hopper::fence_regs(acc.dk[hf]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < Bx::HALVES; ++hf)
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                hopper::mma_rs<T, Bx::COLS>(acc.dv[hf], pa[kk],
                                            hopper::tile_desc<Bx::ROWB>(do_addr + hf * BQ * Bx::ROWB + kk * 16 * Bx::ROWB));
#pragma unroll
        for (int hf = 0; hf < Bx::HALVES; ++hf)
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                hopper::mma_rs<T, Bx::COLS>(acc.dk[hf], dsa[kk],
                                            hopper::tile_desc<Bx::ROWB>(q_addr + hf * BQ * Bx::ROWB + kk * 16 * Bx::ROWB));
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
#pragma unroll
        for (int hf = 0; hf < Bx::HALVES; ++hf) {
            hopper::fence_regs(acc.dv[hf]);
            hopper::fence_regs(acc.dk[hf]);
        }
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    };

    // a q-tile none of this warpgroup's keys is seen by (under a band):
    // freed once its data has landed (so that the arrival cannot count
    // toward the stage's previous tile), its rows of dS^T zero
    auto idle = [=](int i) {
        const int s = i % C::STAGES;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
        hopper::mbar_wait(&staged_empty[i & 1], ((i >> 1) & 1) ^ 1);
        const uint32_t ds = ds_all + (i & 1) * C::DS_TILE + wg * 64 * C::DS_ROWB;
        for (int o = 16 * t; o < 64 * C::DS_ROWB; o += 16 * 128)
            asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(ds + o), "r"(0) : "memory");
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&staged_full[i & 1]);
    };

    if (nq > 0) hopper::mbar_wait(kv_bar, 0);
    if constexpr (BANDED) {
        // the walk's index i is q-tile nq - 1 - i counted up
        for (int i = 0; i < nq - i_hi; ++i) idle(i);
        for (int i = nq - i_hi; i < nq - i_lo; ++i) active(i);
        for (int i = nq - i_lo; i < nq; ++i) idle(i);
    } else {
        for (int i = 0; i < nq; ++i) active(i);
    }
    attn_tc::dkv_finish<T, D>(acc, fr, dkp, p.dk_ss, dvp, p.dv_ss, kw, p.Sk);
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

// acc: fp32, B * H * ceil(Sq / BQ) * BQ * tile_dim(D) (BQ: 64 at D <= 64,
// 32 above); counters: int32, B * H * ceil(Sq / BQ), zero before the first
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
