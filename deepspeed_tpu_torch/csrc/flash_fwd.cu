// flash_fwd: prefill attention with the fp32 logsumexp.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (line 133): online-softmax attention over [B, S, H, D],
// causal end-aligned (offset Sk - Sq), fp32 accumulation, p cast to the
// input dtype before P.V, O and the fp32 lse written (lse feeds the
// backward of the training slice).  kv_lens (optional, int32 [B]) masks
// the keys of row b at or past max(1, kv_lens[b]), the right padding of an
// MLM batch, and its k-tiles wholly past that length are never loaded.
//
// Bound on the H100: 4*D FLOPs per visible (q, k) pair against the bytes
// of q, k, v, O and lse read or written once: about S/4 FLOPs per byte
// under causal masking at D 64, so the bytes over 3.35 TB/s bound the
// serving shapes and the two bounds meet near S 1024.
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
// producer's loads and both consumers' barrier phases agree.
//
// fp32 keeps the FMA kernel of flash_tile.cuh (wgmma transposes 16-bit
// operands only).
#include "attn_tc.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int FWD_BQ = 128;        // query rows per CTA: two warpgroups of 64
constexpr int FWD_BK = 64;         // keys per k-tile
constexpr int FWD_THREADS = 288;   // two consumer warpgroups and the producer warp

struct FwdParams {
    CUtensorMap q, k, v;           // rows of 128 (q) and 64 (k, v) per box
    void* o;
    float* lse;                    // optional [B, H, Sq]
    const int* kv_lens;            // optional [B]
    int Sq, Sk, H;
    long long o_sb, o_ss, o_sh;
    float scale;
    int causal;
};

template <int D>
struct FwdCfg {
    static constexpr int HALVES = D > 64 ? D / 64 : 1;     // TMA boxes per row
    static constexpr int COLS = D < 64 ? D : 64;            // columns per box
    static constexpr int ROWB = 2 * COLS;                   // bytes per box row
    static constexpr int STAGES = D > 64 ? 2 : 3;
    static constexpr int Q_BYTES = HALVES * FWD_BQ * ROWB;
    static constexpr int KV_BYTES = HALVES * FWD_BK * ROWB; // one of K, V
    static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, 1) flash_fwd_tc(const __grid_constant__ FwdParams p) {
    using C = FwdCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;
    uint8_t* kvs = smem + C::Q_BYTES;             // stage s: K, then V
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + C::STAGES;

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_BQ;   // heaviest causal tiles first
    const int off = p.Sk - p.Sq;
    const int klim = p.kv_lens != nullptr ? min(p.Sk, max(1, p.kv_lens[b])) : p.Sk;
    int kend = klim;
    if (p.causal) kend = max(0, min(klim, min(p.Sq, q0 + FWD_BQ) + off));
    const int ntiles = (kend + FWD_BK - 1) / FWD_BK;

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
        if (threadIdx.x == 256 && ntiles > 0) {
            hopper::mbar_expect_tx(q_bar, C::Q_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf)
                hopper::tma_load_4d(qs + hf * FWD_BQ * C::ROWB, &p.q, q_bar, hf * 64, h, q0, b);
            for (int i = 0; i < ntiles; ++i) {
                const int s = i % C::STAGES;
                hopper::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
                uint8_t* ks = kvs + s * 2 * C::KV_BYTES;
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(ks + hf * FWD_BK * C::ROWB, &p.k, &full[s], hf * 64, h, i * FWD_BK, b);
                    hopper::tma_load_4d(ks + C::KV_BYTES + hf * FWD_BK * C::ROWB, &p.v, &full[s], hf * 64, h,
                                        i * FWD_BK, b);
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
    attn_tc::FwdState<D> st;
    st.init();
    const uint32_t q_addr = hopper::smem_u32(qs) + 64 * wg * C::ROWB;
    const bool causal = p.causal;

    if (ntiles > 0) hopper::mbar_wait(q_bar, 0);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % C::STAGES;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        const uint32_t k_addr = hopper::smem_u32(kvs + s * 2 * C::KV_BYTES);
        const int k0 = i * FWD_BK;
        // only the tiles that cross the causal or key-length edge are masked
        const bool crosses = (p.causal && k0 + FWD_BK - 1 > qw + off) || k0 + FWD_BK > klim;
        attn_tc::fwd_step<T, D, FWD_BQ>(st, fr, q_addr, k_addr, k_addr + C::KV_BYTES, p.scale, crosses,
                                        [=](int r, int c) {
                                            const int kj = k0 + c;
                                            return (kj < klim) & (!causal | (kj <= qi[r] + off));
                                        });
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    attn_tc::fwd_finish<T, D>(st, fr, t, static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh, p.o_ss, qw, p.Sq,
                              p.lse != nullptr ? p.lse + ((long long)b * p.H + h) * p.Sq : nullptr);
}

template <typename T, int D>
cudaError_t launch_fwd_tc(const FwdParams& p, int B, cudaStream_t stream) {
    using C = FwdCfg<D>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_fwd_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(p.H, B, (p.Sq + FWD_BQ - 1) / FWD_BQ);
    flash_fwd_tc<T, D><<<grid, FWD_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* kv_lens, int dtype, int B, int Sq, int Sk, int H, int D,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal, void* stream_ptr) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (dtype == kF32) {
        TileArgs a{q, k, v, o, lse, B, Sq, Sk, H,
                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                   scale, causal, nullptr, 0, kv_lens};
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
    p.scale = scale; p.causal = causal;
#define DS_FWD_D(T)                                                    \
    switch (D) {                                                       \
        case 32: return static_cast<int>(launch_fwd_tc<T, 32>(p, B, stream));   \
        case 64: return static_cast<int>(launch_fwd_tc<T, 64>(p, B, stream));   \
        case 128: return static_cast<int>(launch_fwd_tc<T, 128>(p, B, stream)); \
        default: return static_cast<int>(cudaErrorInvalidValue);      \
    }
    if (dtype == kBF16) DS_FWD_D(__nv_bfloat16)
    DS_FWD_D(__half)
#undef DS_FWD_D
}
