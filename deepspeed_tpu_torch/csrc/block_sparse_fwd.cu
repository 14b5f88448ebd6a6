// block_sparse_fwd: block-sparse attention forward with the fp32 logsumexp.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _fwd_kernel (line 107): online-softmax attention over the live blocks of
// a per-head layout only (block_sparse.cuh), positional causal mask inside
// each live block, fp32 accumulation, p rounded to the input dtype before
// P.V (l sums the unrounded p), O and the fp32 lse [B, H, S] written.  A
// row with no live block (or, with a layout that allows it, no visible
// key) keeps m = -inf and l = 0 and ends with O = 0 and lse = -inf, the JAX
// kernel's finalize.
//
// Bound on the H100: 4*D FLOPs per live (q, k) pair against the bytes of
// q, k, v, O and lse.  At the training slice's shape (GPT-2 350M, S 4096,
// Fixed layout, block 64) that is about 0.04 ms either way.
//
// bf16 and fp16 (block_sparse_fwd_tc): the Hopper design, over the tile
// table (block_sparse.cuh).  One CTA owns a (b, h, 64-query tile) unit,
// the units launched in the table's heaviest-first order: one consumer
// warpgroup and a producer warp.  The producer loads Q once and streams
// the live K and V tiles, at the coordinates the table gives, through a
// ring of shared-memory stages with TMA (3 stages, 2 at D 128: about 58 KB
// at D 64, so three CTAs share an SM and their overlap stands in for the
// second warpgroup of flash_fwd_tc).  The consumer runs the step it
// shares with flash_fwd_tc (attn_tc.cuh fwd_step) and masks, by selects, only the tiles that are
// partial: sub-blocks not all live (blocks 16 and 32) or the causal
// diagonal tile.  Dead tiles cost neither loads nor FLOPs; every loop
// count is the unit's live count, so producer and consumer agree on the
// barrier phases; a unit with no live tile writes O = 0 and lse = -inf
// without touching a barrier.
//
// fp32 keeps the FMA kernel below (wgmma transposes 16-bit operands
// only): one CTA per `rows` query rows of one q-block, sweeping the live
// k-blocks of its row of the block table in chunks of KC keys widened to
// fp32 in shared memory; it is bound by the FMA issue rate.
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// 128 (common.cuh tile_dim), with D 128's stages ("D 128" above): S =
// Q.K^T stops at D's last 16-column step, O's padded columns are computed
// on the zeros TMA fills into V and never stored; the FMA kernel pads its
// rows with zeros (block_sparse.cuh).
#include "attn_tc.cuh"
#include "block_sparse.cuh"

template <typename T, int D, int KC>
__global__ void __launch_bounds__(DS_SPARSE_THREADS)
block_sparse_fwd_kernel(const SparseArgs a) {
    constexpr int DT = HeadDim<D>::TILE;          // the padded row
    constexpr int TPR = DT / 16;                  // lanes per query row
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 ks[KC][DT / 4];
    __shared__ float4 vs[KC][DT / 4];

    const int rows = blockDim.x / TPR;
    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int t = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int q0 = blockIdx.x * rows;
    const int qi = q0 + r;
    const int n = a.S / a.block;
    const int qb = q0 / a.block;
    const int* live = a.idx + ((long long)h * n + qb) * a.width;
    const int count = a.cnt[h * n + qb];

    const T* qp = row_ptr<T>(a.q, b, qi, h);
    float4 q[NCH], acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        q[c] = (c * TPR + t) * 4 < D ? load4(qp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float m = -INFINITY;
    float l = 0.f;

    for (int jb = 0; jb < count; ++jb) {
        const int k_first = live[jb] * a.block;
        int k_end = k_first + a.block;
        if (a.causal) k_end = min(k_end, q0 + rows);   // later keys: masked for the whole tile
        for (int k0 = k_first; k0 < k_end; k0 += KC) {
            __syncthreads();                      // the previous chunk is consumed
            stage_rows<T, D, KC, DT>(ks, a.k, b, h, k0);
            stage_rows<T, D, KC, DT>(vs, a.v, b, h, k0);
            __syncthreads();

            float s[KC];
            float tile_max = -INFINITY;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                float part = 0.f;
#pragma unroll
                for (int c = 0; c < NCH; ++c) part += dot4s(q[c], ks[j][c * TPR + t]);
#pragma unroll
                for (int o = TPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
                const bool vis = !a.causal || k0 + j <= qi;
                s[j] = vis ? part * a.scale : -INFINITY;
                tile_max = fmaxf(tile_max, s[j]);
            }
            const float m_new = fmaxf(m, tile_max);
            // a row with no visible key yet keeps m = -inf: guard the
            // subtraction so its p and alpha come out 0, not nan
            const float m_safe = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = expf(m - m_safe);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                const float p = expf(s[j] - m_safe);
                psum += p;
                s[j] = round_to<T>(p);
            }
            l = l * alpha + psum;
            m = m_new;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
            }
#pragma unroll
            for (int j = 0; j < KC; ++j) {
#pragma unroll
                for (int c = 0; c < NCH; ++c) axpy4s(acc[c], s[j], vs[j][c * TPR + t]);
            }
        }
    }

    const float lf = fmaxf(l, 1e-30f);
    const float inv = 1.f / lf;
    T* op = const_cast<T*>(row_ptr<T>(a.out0, b, qi, h));
#pragma unroll
    for (int c = 0; c < NCH; ++c)
        if ((c * TPR + t) * 4 < D)
            store4(op + (c * TPR + t) * 4, acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
    if (t == 0) a.lse[((long long)b * a.H + h) * a.S + qi] = m + logf(lf);
}

template <typename T, int D, int KC>
static cudaError_t launch_fwd(const SparseArgs& a, cudaStream_t stream) {
    dim3 grid, block;
    sparse_grid<D>(a, grid, block);
    block_sparse_fwd_kernel<T, D, KC><<<grid, block, 0, stream>>>(a);
    return cudaGetLastError();
}

namespace {

constexpr int SP_THREADS = 160;    // one consumer warpgroup and the producer warp
constexpr int SP_TILE = 64;        // queries and keys per tile

struct SpFwdParams {
    CUtensorMap q, k, v;           // boxes of 64 rows
    void* o;
    float* lse;                    // [B, H, S]
    TileTable tt;
    int B, S, H, nt;
    long long o_sb, o_ss, o_sh;
    float scale;
    int causal;
    int bl;                        // sub_block_log(block)
};

template <int D>
struct SpFwdCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;
    using attn_tc::Boxes<D>::ROWB;
    static constexpr int STAGES = D > 64 ? 2 : 3;
    static constexpr int TILE_BYTES = HALVES * SP_TILE * ROWB;   // one of Q, K, V
    static constexpr int BAR_OFF = TILE_BYTES + STAGES * 2 * TILE_BYTES;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
    static constexpr int MIN_CTAS = D > 64 ? 2 : 3;
};

template <typename T, int D>
__global__ void __launch_bounds__(SP_THREADS, SpFwdCfg<D>::MIN_CTAS)
block_sparse_fwd_tc(const __grid_constant__ SpFwdParams p) {
    using C = SpFwdCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;
    uint8_t* kvs = smem + C::TILE_BYTES;          // stage s: K, then V
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + C::STAGES;

    const int unit = p.tt.order[blockIdx.x / p.B];    // heaviest units first
    const int b = blockIdx.x % p.B;
    const int h = unit / p.nt;
    const int qt = unit % p.nt;
    const int q0 = qt * SP_TILE;
    // the loop count of every thread: the unit's live tiles (a shuffle
    // shows the compiler it is warp-uniform)
    const int n = __shfl_sync(0xffffffffu, p.tt.cnt[unit], 0);
    const int* live = p.tt.entries + (long long)unit * p.tt.width;
    T* obase = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
    float* lse = p.lse + ((long long)b * p.H + h) * p.S;
    const int t = threadIdx.x;
    const hopper::Frag fr(t % 128);

    if (n == 0) {
        // no live tile: O = 0, lse = -inf
        if (t < 128) {
            attn_tc::FwdState<D> st;
            st.init();
            attn_tc::fwd_finish<T, D>(st, fr, t, obase, p.o_ss, q0, p.S, lse);
        }
        return;
    }

    if (t == 0) {
        hopper::mbar_init(q_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 4);      // one arrival per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (t >= 128) {
        // producer: one thread issues every load
        if (t == 128) {
            hopper::mbar_expect_tx(q_bar, C::TILE_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf)
                hopper::tma_load_4d(qs + hf * SP_TILE * C::ROWB, &p.q, q_bar, hf * 64, h, q0, b);
            for (int i = 0; i < n; ++i) {
                const int k0 = (live[i] & 0xffff) * SP_TILE;
                const int s = i % C::STAGES;
                hopper::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], 2 * C::TILE_BYTES);
                uint8_t* ks = kvs + s * 2 * C::TILE_BYTES;
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(ks + hf * SP_TILE * C::ROWB, &p.k, &full[s], hf * 64, h, k0, b);
                    hopper::tma_load_4d(ks + C::TILE_BYTES + hf * SP_TILE * C::ROWB, &p.v, &full[s], hf * 64, h,
                                        k0, b);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: query rows q0 .. q0 + 63
    attn_tc::FwdState<D> st;
    st.init();
    const int bl = p.bl;
    const unsigned whole = all_live(bl);
    const uint32_t q_addr = hopper::smem_u32(qs);
    hopper::mbar_wait(q_bar, 0);
    for (int i = 0; i < n; ++i) {
        const unsigned e = static_cast<unsigned>(live[i]);
        const unsigned bits = e >> 16;
        const bool diag = p.causal && static_cast<int>(e & 0xffff) == qt;
        const int s = i % C::STAGES;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        const uint32_t k_addr = hopper::smem_u32(kvs + s * 2 * C::TILE_BYTES);
        attn_tc::fwd_step<T, D, SP_TILE>(st, fr, q_addr, k_addr, k_addr + C::TILE_BYTES, p.scale,
                                         diag || bits != whole, [=](int r, int c) {
                                             return tile_visible(bits, fr.row + 8 * r, c, bl, diag);
                                         });
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    attn_tc::fwd_finish<T, D>(st, fr, t, obase, p.o_ss, q0, p.S, lse);
}

template <typename T, int D>
cudaError_t launch_fwd_tc(const SpFwdParams& p, cudaStream_t stream) {
    using C = SpFwdCfg<D>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(block_sparse_fwd_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    block_sparse_fwd_tc<T, D><<<p.B * p.H * p.nt, SP_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int block_sparse_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                const int* idx, const int* cnt,
                                const int* tiles, const int* tile_cnt, const int* tile_order,
                                int dtype, int B, int S, int H, int D, int block, int width, int tile_width,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_ss, long long o_sh,
                                float scale, int causal, void* stream_ptr) {
    if (B == 0 || S == 0 || H == 0) return 0;
    SparseArgs a{{q, q_sb, q_ss, q_sh}, {k, k_sb, k_ss, k_sh}, {v, v_sb, v_ss, v_sh},
                 {nullptr, 0, 0, 0}, {o, o_sb, o_ss, o_sh}, {nullptr, 0, 0, 0},
                 lse, nullptr, idx, cnt, width, B, S, H, block, scale, causal};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (!sparse_args_ok(a) || tile_width < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF32) DS_SPARSE_D(launch_fwd, float)
    if (dtype != kF16 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    SpFwdParams p{};
    cudaError_t err = hopper::map_rows(&p.q, q, dtype, B, S, H, D, q_sb, q_ss, q_sh, SP_TILE);
    if (err == cudaSuccess) err = hopper::map_rows(&p.k, k, dtype, B, S, H, D, k_sb, k_ss, k_sh, SP_TILE);
    if (err == cudaSuccess) err = hopper::map_rows(&p.v, v, dtype, B, S, H, D, v_sb, v_ss, v_sh, SP_TILE);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.o = o; p.lse = lse;
    p.tt = TileTable{tiles, tile_cnt, tile_order, tile_width};
    p.B = B; p.S = S; p.H = H; p.nt = (S + SP_TILE - 1) / SP_TILE;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.scale = scale; p.causal = causal; p.bl = sub_block_log(block);
#define DS_SP_FWD_D(T)                                                          \
    switch (D) {                                                                \
        case 32: return static_cast<int>(launch_fwd_tc<T, 32>(p, stream));     \
        case 64: return static_cast<int>(launch_fwd_tc<T, 64>(p, stream));     \
        case 80: return static_cast<int>(launch_fwd_tc<T, 80>(p, stream));     \
        case 96: return static_cast<int>(launch_fwd_tc<T, 96>(p, stream));     \
        case 128: return static_cast<int>(launch_fwd_tc<T, 128>(p, stream));   \
        default: return static_cast<int>(cudaErrorInvalidValue);               \
    }
    if (dtype == kBF16) DS_SP_FWD_D(__nv_bfloat16)
    DS_SP_FWD_D(__half)
#undef DS_SP_FWD_D
}
