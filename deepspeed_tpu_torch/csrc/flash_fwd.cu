// flash_fwd: prefill attention with the fp32 logsumexp.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (line 133): online-softmax attention over [B, S, H, D],
// causal end-aligned (offset Sk - Sq), fp32 accumulation, p cast to the
// input dtype before P.V, O and the fp32 lse written (lse feeds the
// backward of the training slice).  kv_lens (optional, int32 [B]) masks
// the keys of row b at or past max(1, kv_lens[b]), the right padding of an
// MLM batch, and its k-tiles wholly past that length are never loaded.
// window (the kernel's use_window option, :136-189; causal only, 0 for
// none) bands visibility to 0 <= i + off - j < window, GPT-Neo's local
// layers: a CTA's k-tile walk starts at the tile of its first row's band
// start (JAX _band_block_visible), so tiles wholly below the band are
// never loaded, and a tile that crosses the band's lower edge is masked
// (_block_crosses_mask with use_window).  The window is a launch
// argument: one build serves banded and global layers.
//
// Bound on the H100: 4*D FLOPs per visible (q, k) pair against the bytes
// of q, k, v, O and lse read or written once: about S/4 FLOPs per byte
// under causal masking at D 64, so the bytes over 3.35 TB/s bound the
// serving shapes and the two bounds meet near S 1024.  A band of width w
// leaves about w visible pairs a row, about w/4 FLOPs per byte.
//
// bf16 and fp16 (flash_fwd_tc): the Hopper design.  One CTA owns a
// (b, h, 128-query) tile: two consumer warpgroups of 64 query rows and a
// producer warp.  The producer loads Q once and streams the K and V
// k-tiles (64 keys) through a ring of shared-memory stages with TMA, each
// stage guarded by a full and an empty mbarrier.  Each consumer runs the
// forward step it shares with block_sparse_fwd_tc (attn_tc.cuh fwd_step:
// S = Q.K^T and O += round_T(P).V on wgmma, the online softmax on the
// accumulator fragment, p rounded to T as JAX p.astype(vs.dtype), :184),
// masking only the tiles that cross the causal or key-length edge (JAX
// _block_crosses_mask).  k-tiles above the causal frontier or past the
// key length are never loaded, and the heaviest causal q-tiles are
// scheduled first (the q-tile index is the grid's slowest dimension,
// reversed).  Every loop bound depends on b and the q-tile only, so the
// producer's loads and both consumers' barrier phases agree.  Each
// consumer computes only the k-tiles its own 64 rows see, and frees the
// stage of a tile it skips once the tile has landed.  Under a band every
// q-tile has about the same few k-tiles, so a CTA takes two neighbouring
// q-tiles in turn, each with its own Q buffer loaded up front: the second
// tile's loads overlap the first one's epilogue, where one tile per CTA
// paid a CTA's start-up and drain for every 6 k-tiles.
//
// fp32 keeps the FMA kernel of flash_tile.cuh (wgmma transposes 16-bit
// operands only).
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// 128 (common.cuh tile_dim): S = Q.K^T stops at D's last 16-column step,
// O's columns past D are computed on the zeros TMA fills in and never
// stored.
#include "attn_tc.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int FWD_BQ = 128;        // query rows per CTA: two warpgroups of 64
constexpr int FWD_BK = 64;         // keys per k-tile
constexpr int FWD_THREADS = 288;   // two consumer warpgroups and the producer warp
constexpr int FWD_QPC = 2;         // q-tiles a CTA takes in turn under a band

struct FwdParams {
    CUtensorMap q, k, v;           // rows of 128 (q) and 64 (k, v) per box
    void* o;
    float* lse;                    // optional [B, H, Sq]
    const int* kv_lens;            // optional [B]
    int Sq, Sk, H;
    long long o_sb, o_ss, o_sh;
    float scale;
    int causal;
    int window;                    // band width, 0: none (causal only)
};

// D 80 and 96 take D 128's boxes and stages (attn_tc.cuh Boxes)
template <int D>
struct FwdCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;                        // TMA boxes per row
    using attn_tc::Boxes<D>::ROWB;                          // bytes per box row
    static constexpr int STAGES = D > 64 ? 2 : 3;
    static constexpr int Q_BYTES = HALVES * FWD_BQ * ROWB;
    static constexpr int KV_BYTES = HALVES * FWD_BK * ROWB; // one of K, V
    static constexpr int RING_BYTES = STAGES * 2 * KV_BYTES;
    static constexpr int BARS = 8 * (FWD_QPC + 2 * STAGES);
    // shared memory of a CTA of qpc q-tiles: qpc Q buffers, the ring, the
    // barriers, and the alignment slack
    static constexpr int smem(int qpc) { return qpc * Q_BYTES + RING_BYTES + BARS + 1024; }
};

// The k-tiles of the q-tile at rows q0 .. q0 + 127: [t0, ntiles), from the
// tile of its first row's band start (0 without a band) to its last row's
// frontier (or the key length); uniform over the CTA.
struct QTile {
    int q0, t0, ntiles;
    __device__ __forceinline__ QTile(const FwdParams& p, int q0_, int klim, int off, bool banded) : q0(q0_) {
        int kend = klim;
        if (p.causal) kend = max(0, min(klim, min(p.Sq, q0 + FWD_BQ) + off));
        ntiles = (kend + FWD_BK - 1) / FWD_BK;
        t0 = banded ? min(ntiles, max(0, q0 + off - p.window + 1) / FWD_BK) : 0;
    }
};

// BANDED: causal with a window (built apart, so that the causal kernel
// keeps its one q-tile and both warpgroups on every tile of it)
template <typename T, int D, bool BANDED>
__global__ void __launch_bounds__(FWD_THREADS, 1) flash_fwd_tc(const __grid_constant__ FwdParams p) {
    using C = FwdCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    constexpr int qpc = BANDED ? FWD_QPC : 1;
    uint8_t* qs = smem;                           // q-tile j of the CTA at qs + j Q_BYTES
    uint8_t* kvs = smem + qpc * C::Q_BYTES;       // stage s: K, then V
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(kvs + C::RING_BYTES);   // [FWD_QPC]
    uint64_t* full = q_bar + FWD_QPC;
    uint64_t* empty = full + C::STAGES;

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    // q-tiles qpc z .. qpc z + qpc - 1 counted from the last: the heaviest
    // causal tiles first
    const int nq = (p.Sq + FWD_BQ - 1) / FWD_BQ;
    const int first_tile = nq - 1 - qpc * static_cast<int>(blockIdx.z);
    const int nmine = qpc == 1 ? 1 : min(qpc, first_tile + 1);
    const int off = p.Sk - p.Sq;
    const int klim = p.kv_lens != nullptr ? min(p.Sk, max(1, p.kv_lens[b])) : p.Sk;
    constexpr bool banded = BANDED;
    const int win = banded ? p.window : INT_MAX;

    if (threadIdx.x == 0) {
        for (int j = 0; j < FWD_QPC; ++j) hopper::mbar_init(&q_bar[j], 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // producer: one thread issues every load, each q-tile's Q into its
        // own buffer up front, then the k-tiles of the CTA's q-tiles in turn
        // through the ring (c counts the ring's tiles across q-tiles)
        if (threadIdx.x == 256) {
            for (int j = 0; j < nmine; ++j) {
                const QTile qt(p, (first_tile - j) * FWD_BQ, klim, off, banded);
                if (qt.ntiles <= qt.t0) continue;
                hopper::mbar_expect_tx(&q_bar[j], C::Q_BYTES);
                for (int hf = 0; hf < C::HALVES; ++hf)
                    hopper::tma_load_4d(qs + j * C::Q_BYTES + hf * FWD_BQ * C::ROWB, &p.q, &q_bar[j], hf * 64, h,
                                        qt.q0, b);
            }
            int c = 0;
            for (int j = 0; j < nmine; ++j) {
                const QTile qt(p, (first_tile - j) * FWD_BQ, klim, off, banded);
                for (int i = qt.t0; i < qt.ntiles; ++i, ++c) {
                    const int s = c % C::STAGES;
                    hopper::mbar_wait(&empty[s], ((c / C::STAGES) & 1) ^ 1);
                    hopper::mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
                    uint8_t* ks = kvs + s * 2 * C::KV_BYTES;
                    for (int hf = 0; hf < C::HALVES; ++hf) {
                        hopper::tma_load_4d(ks + hf * FWD_BK * C::ROWB, &p.k, &full[s], hf * 64, h, i * FWD_BK, b);
                        hopper::tma_load_4d(ks + C::KV_BYTES + hf * FWD_BK * C::ROWB, &p.v, &full[s], hf * 64, h,
                                            i * FWD_BK, b);
                    }
                }
            }
        }
        return;
    }

    // consumer warpgroup wg: query rows qw .. qw + 63 of each q-tile
    const int t = threadIdx.x % 128;
    const hopper::Frag fr(t);
    const bool causal = p.causal;
    int c = 0;                                    // the ring's tiles, as the producer counts them
    // a tile this warpgroup skips: freed once its data has landed, so that
    // the arrival cannot count toward the stage's previous tile, which the
    // other warpgroup may still be reading
    auto release = [&](bool wait) {
        const int s = c % C::STAGES;
        if (wait) hopper::mbar_wait(&full[s], (c / C::STAGES) & 1);
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
        ++c;
    };
    for (int j = 0; j < nmine; ++j) {
        const QTile qt(p, (first_tile - j) * FWD_BQ, klim, off, banded);
        const int qw = qt.q0 + 64 * wg;
        const int qi[2] = {qw + fr.row, qw + fr.row + 8};
        // under a band, this warpgroup's own tiles [i_lo, i_hi) of [t0,
        // ntiles): a tile past its last row's frontier or below its first
        // row's band start holds no key it sees, at most one at each end
        // (the other warpgroup's rows are 64 apart).  The bounds go through
        // a shuffle so that ptxas sees them warp-uniform and keeps the
        // wgmma loop free of divergence.
        int i_lo = qt.t0, i_hi = qt.ntiles;
        if constexpr (BANDED) {
            const int last_key = qw + 63 + off;
            i_hi = __shfl_sync(0xffffffffu, last_key < 0 ? qt.t0
                               : max(qt.t0, min(qt.ntiles, last_key / FWD_BK + 1)), 0);
            i_lo = __shfl_sync(0xffffffffu, max(qt.t0, min(i_hi, max(0, qw + off - win + 1) / FWD_BK)), 0);
        }
        attn_tc::FwdState<D> st;
        st.init();
        const uint32_t q_addr = hopper::smem_u32(qs + j * C::Q_BYTES) + 64 * wg * C::ROWB;

        for (int i = qt.t0; i < i_lo; ++i) release(true);
        if (qt.ntiles > qt.t0) hopper::mbar_wait(&q_bar[j], 0);
        for (int i = i_lo; i < i_hi; ++i) {
            const int s = c % C::STAGES;
            hopper::mbar_wait(&full[s], (c / C::STAGES) & 1);
            const uint32_t k_addr = hopper::smem_u32(kvs + s * 2 * C::KV_BYTES);
            const int k0 = i * FWD_BK;
            // only the tiles that cross the causal, key-length or band edge
            // are masked: the band's when the warpgroup's last row is window
            // or more past the tile's first key
            const bool crosses = (causal && k0 + FWD_BK - 1 > qw + off) || k0 + FWD_BK > klim ||
                                 (banded && qw + 63 + off - k0 >= win);
            if constexpr (BANDED) {
                // row r sees the tile's columns lo[r] .. hi[r]: from its
                // band start to its frontier and the key length
                int lo[2], hi[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    lo[r] = qi[r] + off - win + 1 - k0;
                    hi[r] = min(qi[r] + off, klim - 1) - k0;
                }
                attn_tc::fwd_step<T, D, FWD_BQ>(st, fr, q_addr, k_addr, k_addr + C::KV_BYTES, p.scale, crosses,
                                                [=](int r, int cc) { return (cc >= lo[r]) & (cc <= hi[r]); });
            } else {
                attn_tc::fwd_step<T, D, FWD_BQ>(st, fr, q_addr, k_addr, k_addr + C::KV_BYTES, p.scale, crosses,
                                                [=](int r, int cc) {
                                                    const int kj = k0 + cc;
                                                    return (kj < klim) & (!causal | (kj <= qi[r] + off));
                                                });
            }
            release(false);
        }
        for (int i = i_hi; i < qt.ntiles; ++i) release(true);
        attn_tc::fwd_finish<T, D>(st, fr, t, static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh, p.o_ss, qw, p.Sq,
                                  p.lse != nullptr ? p.lse + ((long long)b * p.H + h) * p.Sq : nullptr);
    }
}

template <typename T, int D, bool BANDED>
cudaError_t launch_fwd_tc(const FwdParams& p, int B, cudaStream_t stream) {
    constexpr int qpc = BANDED ? FWD_QPC : 1;
    constexpr int smem = FwdCfg<D>::smem(qpc);
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_fwd_tc<T, D, BANDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    const int nq = (p.Sq + FWD_BQ - 1) / FWD_BQ;
    const dim3 grid(p.H, B, (nq + qpc - 1) / qpc);
    flash_fwd_tc<T, D, BANDED><<<grid, FWD_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_tc(const FwdParams& p, int B, cudaStream_t stream) {
    return p.causal && p.window > 0 ? launch_fwd_tc<T, D, true>(p, B, stream)
                                    : launch_fwd_tc<T, D, false>(p, B, stream);
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* kv_lens, int dtype, int B, int Sq, int Sk, int H, int D,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal, int window, void* stream_ptr) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (dtype == kF32) {
        TileArgs a{q, k, v, o, lse, B, Sq, Sk, H,
                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                   scale, causal, nullptr, 0, kv_lens};
        a.window = window;
        return static_cast<int>(dispatch_tile<false>(D, a, stream));
    }
    if (dtype != kF16 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    FwdParams p{};
    cudaError_t err = hopper::map_rows(&p.q, q, dtype, B, Sq, H, D, q_sb, q_ss, q_sh, FWD_BQ);
    // with no keys nothing is loaded (the maps stay empty): O = 0, lse = -inf
    if (err == cudaSuccess && Sk > 0)
        err = hopper::map_rows(&p.k, k, dtype, B, Sk, H, D, k_sb, k_ss, k_sh, FWD_BK);
    if (err == cudaSuccess && Sk > 0)
        err = hopper::map_rows(&p.v, v, dtype, B, Sk, H, D, v_sb, v_ss, v_sh, FWD_BK);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.o = o; p.lse = lse; p.kv_lens = kv_lens;
    p.Sq = Sq; p.Sk = Sk; p.H = H;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.scale = scale; p.causal = causal; p.window = window;
#define DS_FWD_D(T)                                                    \
    switch (D) {                                                       \
        case 32: return static_cast<int>(launch_fwd_tc<T, 32>(p, B, stream));   \
        case 64: return static_cast<int>(launch_fwd_tc<T, 64>(p, B, stream));   \
        case 80: return static_cast<int>(launch_fwd_tc<T, 80>(p, B, stream));   \
        case 96: return static_cast<int>(launch_fwd_tc<T, 96>(p, B, stream));   \
        case 128: return static_cast<int>(launch_fwd_tc<T, 128>(p, B, stream)); \
        default: return static_cast<int>(cudaErrorInvalidValue);      \
    }
    if (dtype == kBF16) DS_FWD_D(__nv_bfloat16)
    DS_FWD_D(__half)
#undef DS_FWD_D
}
