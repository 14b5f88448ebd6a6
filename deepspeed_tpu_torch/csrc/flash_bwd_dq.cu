// flash_bwd_dq: dQ of the flash-attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd_dq_kernel (line 246): dQ = sum_k dS.K over the keys each query sees,
// with dS recomputed from the saved lse and delta (flash_bwd.cuh), and its
// use_window option (:263-265, 281-282, 290-292): a launch argument, 0 for
// none, so one build serves GPT-Neo's banded and global layers.
//
// Bound on the H100: 6*D FLOPs per visible pair against the bytes of q,
// k, v, dO, dQ, lse and delta read or written once; at the training
// slice's shape (B 16, S 1024, H 16, D 64, causal) that is about 300
// FLOPs per byte, just above the card's 295 bf16 FLOPs per byte, so the
// least time is the operations over 989 TFLOP/s.
//
// bf16 and fp16 (flash_bwd_dq_tc): the Hopper design, the counterpart of
// flash_fwd_tc with the roles of JAX :246-301.  One CTA owns a (b, h,
// 128-query) tile: two consumer warpgroups of 64 query rows and a
// producer warp.  The producer loads the Q and dO tiles once with TMA
// (4-D maps over the strided [B, S, H, D] views, so packed qkv and an
// aligned dO load in place), then streams the K and V k-tiles (64 keys)
// through a ring of shared-memory stages guarded by full and empty
// mbarriers (3 stages at D <= 64, 2 in the tile of 128), from key 0 to the causal
// frontier or the key length: k-tiles past either are never loaded.
// Each consumer thread reads its two rows' lse (times log2 e) and delta
// into registers once, before the loop (rows past Sq get 0 and are
// masked).  Per k-tile each consumer runs the step it shares with
// block_sparse_bwd_dq_tc (attn_tc.cuh dq_step):
//   S = Q.K^T and dP = dO.V^T     (wgmma, both operands K-major)
//   P = exp(S * scale - lse)      (a select, never -inf arithmetic: rows
//                                  with no key have lse = -inf)
//   dS = round_T(P (dP - delta) scale), from the unrounded P (JAX :286)
//   dQ += dS.K                    (wgmma, dS from registers, the same K
//                                  tile read MN-major)
// with fp32 accumulators; only tiles that cross the causal, key-length or
// Sq edge are masked (JAX _block_crosses_mask).  In the tile of 128 dQ is
// two N=64 products over K's two 64-column boxes.  dQ is written once per element
// through the strided dq view (no atomics: two launches are bitwise
// equal), and the heaviest causal q-tiles run first (the q-tile index is
// the grid's slowest dimension, reversed).
//
// Under a band (flash_bwd_dq_tc<T, D, true>, built apart so that the causal
// kernel keeps its loop) the walk starts at the k-tile of the q-tile's
// first row's band start, so a q-tile of 128 rows reads about 6 k-tiles of
// 64 whatever its position (window 256); each warpgroup computes only the
// tiles its own 64 rows see and frees the others once they land, and only
// tiles that cross the band's lower edge, the diagonal or the key length
// are masked.  The reversed q-tile order is kept: under a band the tiles
// weigh about the same, and the walk depends on q0 alone.  (Two q-tiles a
// CTA, as the banded forward takes, measured 0.454x the causal kernel
// against this design's 0.456x on an H100 at B8 S2048 D128, and were not
// kept.)
//
// fp32 keeps the FMA kernel below (flash_bwd_dq_kernel): wgmma transposes
// only 16-bit operands, and dQ += dS.K reads K transposed.  One CTA of 128
// threads owns a (b, h, q-tile) and walks the k-tiles up to its causal
// frontier (from its first row's band start under a window); a query
// row is held by TPR = DT/16 neighbouring lanes, each k-tile widened to
// fp32 in shared memory and reused by all BQ rows, 3*D FMAs per visible
// pair.
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// DT = 128 (common.cuh tile_dim): the tensor-core kernel's S and dP stop
// at D's last 16-column step, dQ's padded columns are computed on the
// zeros TMA fills into K and never stored (dq may be a view into a wider
// tensor); the FMA kernel pads its rows with zeros, so TPR stays a power
// of two and the row's shuffles stay within it.
#include "attn_tc.cuh"
#include "flash_bwd.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(DS_BWD_THREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
    constexpr int DT = HeadDim<D>::TILE;          // the padded row
    constexpr int TPR = DT / 16;                  // lanes per query row
    constexpr int BQ = DS_BWD_THREADS / TPR;      // query rows per CTA
    constexpr int BK = DT <= 64 ? 64 : 32;        // keys per k-tile
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 ks[BK][DT / 4];
    __shared__ float4 vs[BK][DT / 4];

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int t = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int q0 = blockIdx.x * BQ;
    const int qi = q0 + r;
    const bool row_ok = qi < a.Sq;
    const int off = a.Sk - a.Sq;
    const int klim = key_limit(a, b);             // keys at or past it are padding
    int kend = klim;
    if (a.causal) {
        const int last_row = min(a.Sq, q0 + BQ) - 1;
        kend = max(0, min(klim, last_row + off + 1));
    }
    // under a band the walk starts at the k-tile of the first row's band
    // start: tiles below every row's band are never loaded
    const bool band = banded(a);
    const int kbeg = band ? max(0, q0 + off - a.window + 1) / BK * BK : 0;

    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)qi * a.q_ss + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + (long long)qi * a.do_ss + h * a.do_sh;
    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

    float4 q[NCH], dout[NCH], acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const bool ok = row_ok && (c * TPR + t) * 4 < D;   // the padded columns: zero
        q[c] = ok ? load4(qp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dout[c] = ok ? load4(dop + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const long long stat = ((long long)b * a.H + h) * a.Sq + qi;
    const float lse = row_ok ? a.lse[stat] : 0.f;
    const float delta = row_ok ? a.delta[stat] : 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        __syncthreads();                          // the previous tile is consumed
        load_rows<T, D, BK, DT>(ks, kp, a.k_ss, k0, klim);
        load_rows<T, D, BK, DT>(vs, vp, a.v_ss, k0, klim);
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                s += dot4(q[c], ks[j][c * TPR + t]);
                dp += dot4(dout[c], vs[j][c * TPR + t]);
            }
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, o);
                dp += __shfl_xor_sync(0xffffffffu, dp, o);
            }
            const int kj = k0 + j;
            const bool vis = row_ok && kj < klim && (!a.causal || kj <= qi + off) &&
                             (!band || qi + off - kj < a.window);
            float ds = 0.f;
            if (vis) {
                const float p = expf(s * a.scale - lse);
                ds = round_to<T>(p * (dp - delta) * a.scale);
            }
#pragma unroll
            for (int c = 0; c < NCH; ++c) axpy4(acc[c], ds, ks[j][c * TPR + t]);
        }
    }

    if (!row_ok) return;
    T* dqp = static_cast<T*>(a.dq) + b * a.dq_sb + (long long)qi * a.dq_ss + h * a.dq_sh;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
        if ((c * TPR + t) * 4 < D) store4(dqp + (c * TPR + t) * 4, acc[c].x, acc[c].y, acc[c].z, acc[c].w);
}

template <typename T, int D>
static cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
    constexpr int BQ = DS_BWD_THREADS / (HeadDim<D>::TILE / 16);
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, DS_BWD_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

namespace {

constexpr int DQ_BQ = 128;         // query rows per CTA: two warpgroups of 64
constexpr int DQ_BK = 64;          // keys per k-tile
constexpr int DQ_THREADS = 288;    // two consumer warpgroups and the producer warp

struct DqParams {
    CUtensorMap q, dout;           // rows of 128 per box
    CUtensorMap k, v;              // rows of 64 per box
    const float* lse; const float* delta;   // [B, H, Sq]
    void* dq;
    const int* kv_lens;
    int Sq, Sk, H;
    long long dq_sb, dq_ss, dq_sh;
    float scale;
    int causal;
    int window;                    // band width (causal only), 0: none
};

template <int D>
struct DqCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;
    using attn_tc::Boxes<D>::ROWB;
    static constexpr int STAGES = D > 64 ? 2 : 3;
    static constexpr int Q_BYTES = HALVES * DQ_BQ * ROWB;   // one of Q, dO
    static constexpr int KV_BYTES = HALVES * DQ_BK * ROWB;  // one of K, V
    static constexpr int RING_OFF = 2 * Q_BYTES;            // stage s: K, then V
    static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * KV_BYTES;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

// BANDED: causal with a window (built apart, so that the causal kernel
// keeps its loop: both warpgroups on every tile from key 0)
template <typename T, int D, bool BANDED>
__global__ void __launch_bounds__(DQ_THREADS, 1) flash_bwd_dq_tc(const __grid_constant__ DqParams p) {
    using C = DqCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;                           // Q, then dO
    uint8_t* kvs = smem + C::RING_OFF;
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + C::STAGES;

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BQ;    // heaviest causal tiles first
    const int off = p.Sk - p.Sq;
    const int klim = p.kv_lens != nullptr ? min(p.Sk, max(1, p.kv_lens[b])) : p.Sk;
    int kend = klim;
    if (p.causal) kend = max(0, min(klim, min(p.Sq, q0 + DQ_BQ) + off));
    const int ntiles = (kend + DQ_BK - 1) / DQ_BK;
    // the k-tiles [t0, ntiles): under a band from the tile of the q-tile's
    // first row's band start (JAX _band_block_visible), else from key 0;
    // uniform over the CTA, so the producer and both consumers agree
    const int win = BANDED ? p.window : 0;
    const int t0 = BANDED ? min(ntiles, max(0, q0 + off - win + 1) / DQ_BK) : 0;

    if (threadIdx.x == 0) {
        hopper::mbar_init(q_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // producer: one thread issues every load
        if (threadIdx.x == 256 && ntiles > t0) {
            hopper::mbar_expect_tx(q_bar, 2 * C::Q_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf) {
                hopper::tma_load_4d(qs + hf * DQ_BQ * C::ROWB, &p.q, q_bar, hf * 64, h, q0, b);
                hopper::tma_load_4d(qs + C::Q_BYTES + hf * DQ_BQ * C::ROWB, &p.dout, q_bar, hf * 64, h, q0, b);
            }
            for (int i = t0; i < ntiles; ++i) {
                const int s = (i - t0) % C::STAGES;
                hopper::mbar_wait(&empty[s], (((i - t0) / C::STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
                uint8_t* ks = kvs + s * 2 * C::KV_BYTES;
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(ks + hf * DQ_BK * C::ROWB, &p.k, &full[s], hf * 64, h, i * DQ_BK, b);
                    hopper::tma_load_4d(ks + C::KV_BYTES + hf * DQ_BK * C::ROWB, &p.v, &full[s], hf * 64, h,
                                        i * DQ_BK, b);
                }
            }
        }
        return;
    }

    // consumer warpgroup wg: query rows qw .. qw + 63
    const int t = threadIdx.x % 128;
    const hopper::Frag fr(t);
    const int qw = q0 + 64 * wg;
    const int qi[2] = {qw + fr.row, qw + fr.row + 8};
    // lse (times log2 e, as ex2 takes it) and delta of the thread's two
    // rows, fixed over the loop; rows past Sq get 0 and are masked
    float lse2[2], dlt[2];
    const long long stat0 = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const bool ok = qi[r] < p.Sq;
        lse2[r] = ok ? p.lse[stat0 + qi[r]] * hopper::LOG2E : 0.f;
        dlt[r] = ok ? p.delta[stat0 + qi[r]] : 0.f;
    }
    attn_tc::DqAcc<D> acc;
    acc.init();
    const uint32_t q_addr = hopper::smem_u32(qs) + 64 * wg * C::ROWB;
    const uint32_t do_addr = q_addr + C::Q_BYTES;
    const int Sq = p.Sq;
    const bool causal = p.causal;

    // under a band, this warpgroup's own tiles [i_lo, i_hi) of [t0,
    // ntiles): a tile past its last row's frontier or below its first
    // row's band start holds no key it sees (the other warpgroup's rows
    // are 64 apart).  The bounds go through a shuffle so that ptxas sees
    // them warp-uniform and keeps the wgmma loop free of divergence.
    int i_lo = t0, i_hi = ntiles;
    if constexpr (BANDED) {
        const int last_key = qw + 63 + off;
        i_hi = __shfl_sync(0xffffffffu, last_key < 0 ? t0 : max(t0, min(ntiles, last_key / DQ_BK + 1)), 0);
        i_lo = __shfl_sync(0xffffffffu, max(t0, min(i_hi, max(0, qw + off - win + 1) / DQ_BK)), 0);
    }
    // a tile this warpgroup skips: freed once its data has landed, so that
    // the arrival cannot count toward the stage's previous tile, which the
    // other warpgroup may still be reading
    auto release = [&](int i) {
        const int s = (i - t0) % C::STAGES;
        hopper::mbar_wait(&full[s], ((i - t0) / C::STAGES) & 1);
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    };
    for (int i = t0; i < i_lo; ++i) release(i);
    if (ntiles > t0) hopper::mbar_wait(q_bar, 0);
    for (int i = i_lo; i < i_hi; ++i) {
        const int s = (i - t0) % C::STAGES;
        hopper::mbar_wait(&full[s], ((i - t0) / C::STAGES) & 1);
        const uint32_t k_addr = hopper::smem_u32(kvs + s * 2 * C::KV_BYTES);
        const int k0 = i * DQ_BK;
        if constexpr (BANDED) {
            // only tiles that cross the causal, key-length or band edge are
            // masked: the band's when the warpgroup's last row is window or
            // more past the tile's first key.  Rows past Sq are never
            // stored, and a row's dS feeds only its own dQ, so they need no
            // mask (their Q and dO are TMA's zero fill, lse and delta 0).
            const bool crosses = k0 + DQ_BK - 1 > qw + off || k0 + DQ_BK > klim || qw + 63 + off - k0 >= win;
            // row r sees the tile's columns lo[r] .. hi[r]: from its band
            // start to its frontier and the key length
            int lo[2], hi[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                lo[r] = qi[r] + off - win + 1 - k0;
                hi[r] = min(qi[r] + off, klim - 1) - k0;
            }
            attn_tc::dq_step<T, D, DQ_BQ>(acc, fr, q_addr, do_addr, k_addr, k_addr + C::KV_BYTES, lse2, dlt,
                                          p.scale, crosses,
                                          [=](int r, int c) { return (c >= lo[r]) & (c <= hi[r]); });
        } else {
            // only k-tiles that cross the causal, key-length or Sq edge are masked
            const bool crosses = (p.causal && k0 + DQ_BK - 1 > qw + off) || k0 + DQ_BK > klim || qw + 64 > p.Sq;
            attn_tc::dq_step<T, D, DQ_BQ>(acc, fr, q_addr, do_addr, k_addr, k_addr + C::KV_BYTES, lse2, dlt,
                                          p.scale, crosses, [=](int r, int c) {
                                              const int kj = k0 + c;
                                              return (kj < klim) & (qi[r] < Sq) & (!causal | (kj <= qi[r] + off));
                                          });
        }
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    for (int i = i_hi; i < ntiles; ++i) release(i);
    T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    attn_tc::dq_finish<T, D>(acc, fr, dqp, p.dq_ss, qw, p.Sq);
}

template <typename T, int D, bool BANDED>
cudaError_t launch_dq_tc(const BwdArgs& a, int dtype, cudaStream_t stream) {
    using C = DqCfg<D>;
    DqParams p{};
    cudaError_t err = hopper::map_rows(&p.q, a.q, dtype, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, a.q_sh, DQ_BQ);
    if (err == cudaSuccess)
        err = hopper::map_rows(&p.dout, a.dout, dtype, a.B, a.Sq, a.H, D, a.do_sb, a.do_ss, a.do_sh, DQ_BQ);
    // with no keys nothing but Q and dO would be loaded, and not even
    // those: every row writes dQ = 0
    if (a.Sk > 0) {
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.k, a.k, dtype, a.B, a.Sk, a.H, D, a.k_sb, a.k_ss, a.k_sh, DQ_BK);
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.v, a.v, dtype, a.B, a.Sk, a.H, D, a.v_sb, a.v_ss, a.v_sh, DQ_BK);
    }
    if (err != cudaSuccess) return err;
    p.lse = a.lse; p.delta = a.delta;
    p.dq = a.dq; p.kv_lens = a.kv_lens;
    p.Sq = a.Sq; p.Sk = a.Sk; p.H = a.H;
    p.dq_sb = a.dq_sb; p.dq_ss = a.dq_ss; p.dq_sh = a.dq_sh;
    p.scale = a.scale; p.causal = a.causal; p.window = a.window;
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_bwd_dq_tc<T, D, BANDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(a.H, a.B, (a.Sq + DQ_BQ - 1) / DQ_BQ);
    flash_bwd_dq_tc<T, D, BANDED><<<grid, DQ_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tc(const BwdArgs& a, int dtype, cudaStream_t stream) {
    return banded(a) ? launch_dq_tc<T, D, true>(a, dtype, stream) : launch_dq_tc<T, D, false>(a, dtype, stream);
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* kv_lens,
                            void* dq, int dtype, int B, int Sq, int Sk, int H, int D,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long do_sb, long long do_ss, long long do_sh,
                            long long dq_sb, long long dq_ss, long long dq_sh,
                            float scale, int causal, int window, void* stream_ptr) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk, H,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
              dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, scale, causal, kv_lens, window};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define DS_DQ_D(T, LAUNCH, ...)                                         \
    switch (D) {                                                         \
        case 32: return static_cast<int>(LAUNCH<T, 32>(a, ##__VA_ARGS__, stream));   \
        case 64: return static_cast<int>(LAUNCH<T, 64>(a, ##__VA_ARGS__, stream));   \
        case 80: return static_cast<int>(LAUNCH<T, 80>(a, ##__VA_ARGS__, stream));   \
        case 96: return static_cast<int>(LAUNCH<T, 96>(a, ##__VA_ARGS__, stream));   \
        case 128: return static_cast<int>(LAUNCH<T, 128>(a, ##__VA_ARGS__, stream)); \
        default: return static_cast<int>(cudaErrorInvalidValue);        \
    }
    switch (dtype) {
        case kF32: DS_DQ_D(float, launch_dq)
        case kF16: DS_DQ_D(__half, launch_dq_tc, dtype)
        case kBF16: DS_DQ_D(__nv_bfloat16, launch_dq_tc, dtype)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DS_DQ_D
}
