// block_sparse_bwd_dq: dQ of the block-sparse attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _bwd_dq_kernel (line 193): dQ = sum_k dS.K over the live keys each query
// sees, with p = exp(s * scale - lse) recomputed from the forward's fp32
// logsumexp and dS = round_T(p * (dP - delta) * scale), dP = dO.V, delta =
// rowsum(dO * O) precomputed in fp32 [B, H, S] (the JAX kernel's rounding).
// A pair is masked before the exponential, and so is a row whose lse is
// -inf, so no gradient is ever NaN.  Each dQ element is written once by
// one CTA, with no atomics, so two launches are bitwise equal.
//
// Bound on the H100: 6*D FLOPs per live pair against the bytes of q, k, v,
// dO, dQ, lse and delta read or written once; at the sparse training
// slice's shape (GPT-2 350M, S 4096, Fixed layout, block 64) the
// operations bound it, about 0.06 ms.
//
// bf16 and fp16 (block_sparse_bwd_dq_tc): the Hopper design, over the row
// tile table (block_sparse.cuh), the skeleton of block_sparse_fwd_tc with
// the step of flash_bwd_dq_tc.  One CTA owns a (b, h, 64-query tile)
// unit, the units launched in the table's heaviest-first order: one
// consumer warpgroup and a producer warp.  The producer loads the Q and dO
// tiles once with TMA and streams the live K and V tiles, at the
// coordinates the table gives, through a ring of shared-memory stages (3
// stages, 2 at D 128: about 66 KB at D 64 and 98 KB at D 128, so three or
// two CTAs share an SM).  The consumer copies its rows' lse (times
// log2 e) and delta into shared memory once (rows past S get 0) and
// reads them back per tile: three CTAs an SM hold a thread to 128
// registers, and the four that kept them in registers made bf16 D64
// spill (holding them in shared memory costs 2% of the time).  It runs
// the step it shares with flash_bwd_dq_tc (attn_tc.cuh dq_step) on every
// live tile, masking by selects only the tiles that are partial:
// sub-blocks not all live (blocks 16 and 32) or the causal diagonal tile.
// A row whose lse is -inf (at blocks 16 and 32, a row whose sub-block row
// has no live bit) has an infinite exponential; it only ever occurs in a
// partial tile, because its sub-block row leaves the tile's bits
// incomplete, so the select drops it and its dQ stays 0.  Every loop
// count is the unit's live count, so producer and consumer agree on the
// barrier phases; a unit with no live tile writes dQ = 0 without touching
// a barrier.  TMA zero-fills the Q and dO rows past S, and the stores
// stop at S.
//
// fp32 keeps the FMA kernel below (wgmma transposes 16-bit operands
// only, and dQ += dS.K reads K transposed): one CTA owns `rows` query rows
// of one q-block and walks its row of the block table, each live block in
// chunks of KC keys staged once in shared memory as fp32, 3*D FMAs per
// live pair (s = q.k, dP = dO.v, dQ += dS*k).  It is bound by the FMA
// issue rate.
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// 128 (common.cuh tile_dim), with D 128's stages ("D 128" above): S and dP
// stop at D's last 16-column step, dQ's padded columns are computed on the
// zeros TMA fills into K and never stored (dq is a view into the packed
// gradient); the FMA kernel pads its rows with zeros (block_sparse.cuh).
#include "attn_tc.cuh"
#include "block_sparse.cuh"

template <typename T, int D, int KC>
__global__ void __launch_bounds__(DS_SPARSE_THREADS)
block_sparse_bwd_dq_kernel(const SparseArgs a) {
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
    const T* dop = row_ptr<T>(a.dout, b, qi, h);
    float4 q[NCH], dout[NCH], acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const bool ok = (c * TPR + t) * 4 < D;    // the padded columns: zero
        q[c] = ok ? load4(qp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dout[c] = ok ? load4(dop + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const long long stat = ((long long)b * a.H + h) * a.S + qi;
    const float lse = a.lse[stat];
    const float delta = a.delta[stat];
    const bool row_live = lse > -INFINITY;

    for (int jb = 0; jb < count; ++jb) {
        const int k_first = live[jb] * a.block;
        int k_end = k_first + a.block;
        if (a.causal) k_end = min(k_end, q0 + rows);
        for (int k0 = k_first; k0 < k_end; k0 += KC) {
            __syncthreads();                      // the previous chunk is consumed
            stage_rows<T, D, KC, DT>(ks, a.k, b, h, k0);
            stage_rows<T, D, KC, DT>(vs, a.v, b, h, k0);
            __syncthreads();
#pragma unroll 4
            for (int j = 0; j < KC; ++j) {
                float s = 0.f, dp = 0.f;
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    s += dot4s(q[c], ks[j][c * TPR + t]);
                    dp += dot4s(dout[c], vs[j][c * TPR + t]);
                }
#pragma unroll
                for (int o = TPR / 2; o > 0; o >>= 1) {
                    s += __shfl_xor_sync(0xffffffffu, s, o);
                    dp += __shfl_xor_sync(0xffffffffu, dp, o);
                }
                const bool vis = row_live && (!a.causal || k0 + j <= qi);
                float ds = 0.f;
                if (vis) {
                    const float p = expf(s * a.scale - lse);
                    ds = round_to<T>(p * (dp - delta) * a.scale);
                }
#pragma unroll
                for (int c = 0; c < NCH; ++c) axpy4s(acc[c], ds, ks[j][c * TPR + t]);
            }
        }
    }

    T* dqp = const_cast<T*>(row_ptr<T>(a.out0, b, qi, h));
#pragma unroll
    for (int c = 0; c < NCH; ++c)
        if ((c * TPR + t) * 4 < D) store4(dqp + (c * TPR + t) * 4, acc[c].x, acc[c].y, acc[c].z, acc[c].w);
}

template <typename T, int D, int KC>
static cudaError_t launch_dq(const SparseArgs& a, cudaStream_t stream) {
    dim3 grid, block;
    sparse_grid<D>(a, grid, block);
    block_sparse_bwd_dq_kernel<T, D, KC><<<grid, block, 0, stream>>>(a);
    return cudaGetLastError();
}

namespace {

constexpr int SP_THREADS = 160;    // one consumer warpgroup and the producer warp
constexpr int SP_TILE = 64;        // queries and keys per tile

struct SpDqParams {
    CUtensorMap q, dout, k, v;     // boxes of 64 rows
    const float* lse; const float* delta;   // [B, H, S]
    void* dq;
    TileTable tt;                  // the row table
    int B, S, H, nt;
    long long dq_sb, dq_ss, dq_sh;
    float scale;
    int causal;
    int bl;                        // sub_block_log(block)
};

template <int D>
struct SpDqCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;
    using attn_tc::Boxes<D>::ROWB;
    static constexpr int STAGES = D > 64 ? 2 : 3;
    static constexpr int TILE_BYTES = HALVES * SP_TILE * ROWB;   // one of Q, dO, K, V
    static constexpr int RING_OFF = 2 * TILE_BYTES;              // after Q and dO; stage s: K, then V
    static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * TILE_BYTES;
    static constexpr int STAT_OFF = BAR_OFF + 8 * (1 + 2 * STAGES);   // the tile's lse2, then delta
    static constexpr int SMEM = STAT_OFF + 2 * SP_TILE * 4 + 1024;   // + alignment slack
    static constexpr int MIN_CTAS = D > 64 ? 2 : 3;
};

template <typename T, int D>
__global__ void __launch_bounds__(SP_THREADS, SpDqCfg<D>::MIN_CTAS)
block_sparse_bwd_dq_tc(const __grid_constant__ SpDqParams p) {
    using C = SpDqCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;                           // Q, then dO
    uint8_t* kvs = smem + C::RING_OFF;
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
    const int t = threadIdx.x;

    if (n == 0) {
        // no live tile: every row has lse = -inf and dQ = 0, nothing loaded
        T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
        const int rows = min(SP_TILE, p.S - q0);
        for (int id = t; id < rows * D; id += SP_THREADS)
            dqp[(long long)(q0 + id / D) * p.dq_ss + id % D] = from_float<T>(0.f);
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
            hopper::mbar_expect_tx(q_bar, 2 * C::TILE_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf) {
                hopper::tma_load_4d(qs + hf * SP_TILE * C::ROWB, &p.q, q_bar, hf * 64, h, q0, b);
                hopper::tma_load_4d(qs + C::TILE_BYTES + hf * SP_TILE * C::ROWB, &p.dout, q_bar, hf * 64, h, q0,
                                    b);
            }
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
    const hopper::Frag fr(t);
    // lse (times log2 e, as ex2 takes it) and delta of the tile's rows,
    // copied once into shared memory (rows past S get 0; they lie in
    // partial tiles only, since their sub-blocks have no bit, so they are
    // masked) and read back on every tile: held in registers across the
    // loop they cost the four registers that, at three CTAs an SM (128 a
    // thread), made bf16 D64 spill
    float* stat = reinterpret_cast<float*>(smem + C::STAT_OFF);
    if ((t & 3) == 0) {
        const long long stat0 = ((long long)b * p.H + h) * p.S;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = fr.row + 8 * r;
            const bool ok = q0 + row < p.S;
            stat[row] = ok ? p.lse[stat0 + q0 + row] * hopper::LOG2E : 0.f;
            stat[SP_TILE + row] = ok ? p.delta[stat0 + q0 + row] : 0.f;
        }
    }
    hopper::named_sync(1, 128);                   // the consumer warpgroup only
    attn_tc::DqAcc<D> acc;
    acc.init();
    const int bl = p.bl;
    const unsigned whole = all_live(bl);
    const uint32_t q_addr = hopper::smem_u32(qs);
    const uint32_t kv_addr = hopper::smem_u32(kvs);
    hopper::mbar_wait(q_bar, 0);
    for (int i = 0; i < n; ++i) {
        const unsigned e = static_cast<unsigned>(live[i]);
        const unsigned bits = e >> 16;
        const bool diag = p.causal && static_cast<int>(e & 0xffff) == qt;
        const int s = i % C::STAGES;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        const uint32_t k_addr = kv_addr + s * 2 * C::TILE_BYTES;
        const float lse2[2] = {stat[fr.row], stat[fr.row + 8]};
        const float dlt[2] = {stat[SP_TILE + fr.row], stat[SP_TILE + fr.row + 8]};
        // an unmasked tile has every sub-block live, so each of its rows
        // has a finite lse: the rows with lse = -inf meet only the select
        attn_tc::dq_step<T, D, SP_TILE>(acc, fr, q_addr, q_addr + C::TILE_BYTES, k_addr, k_addr + C::TILE_BYTES,
                                        lse2, dlt, p.scale, diag || bits != whole, [=](int r, int c) {
                                            return tile_visible(bits, fr.row + 8 * r, c, bl, diag);
                                        });
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    attn_tc::dq_finish<T, D>(acc, fr, dqp, p.dq_ss, q0, p.S);
}

template <typename T, int D>
cudaError_t launch_dq_tc(const SpDqParams& p, cudaStream_t stream) {
    using C = SpDqCfg<D>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(block_sparse_bwd_dq_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    block_sparse_bwd_dq_tc<T, D><<<p.B * p.H * p.nt, SP_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int block_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                   float* lse, const float* delta, void* dq,
                                   const int* idx, const int* cnt,
                                   const int* tiles, const int* tile_cnt, const int* tile_order,
                                   int dtype, int B, int S, int H, int D, int block, int width, int tile_width,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long do_sb, long long do_ss, long long do_sh,
                                   long long dq_sb, long long dq_ss, long long dq_sh,
                                   float scale, int causal, void* stream_ptr) {
    if (B == 0 || S == 0 || H == 0) return 0;
    SparseArgs a{{q, q_sb, q_ss, q_sh}, {k, k_sb, k_ss, k_sh}, {v, v_sb, v_ss, v_sh},
                 {dout, do_sb, do_ss, do_sh}, {dq, dq_sb, dq_ss, dq_sh}, {nullptr, 0, 0, 0},
                 lse, delta, idx, cnt, width, B, S, H, block, scale, causal};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (!sparse_args_ok(a) || tile_width < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF32) DS_SPARSE_D(launch_dq, float)
    if (dtype != kF16 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    SpDqParams p{};
    cudaError_t err = hopper::map_rows(&p.q, q, dtype, B, S, H, D, q_sb, q_ss, q_sh, SP_TILE);
    if (err == cudaSuccess) err = hopper::map_rows(&p.dout, dout, dtype, B, S, H, D, do_sb, do_ss, do_sh, SP_TILE);
    if (err == cudaSuccess) err = hopper::map_rows(&p.k, k, dtype, B, S, H, D, k_sb, k_ss, k_sh, SP_TILE);
    if (err == cudaSuccess) err = hopper::map_rows(&p.v, v, dtype, B, S, H, D, v_sb, v_ss, v_sh, SP_TILE);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.lse = lse; p.delta = delta; p.dq = dq;
    p.tt = TileTable{tiles, tile_cnt, tile_order, tile_width};
    p.B = B; p.S = S; p.H = H; p.nt = (S + SP_TILE - 1) / SP_TILE;
    p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
    p.scale = scale; p.causal = causal; p.bl = sub_block_log(block);
#define DS_SP_DQ_D(T)                                                          \
    switch (D) {                                                               \
        case 32: return static_cast<int>(launch_dq_tc<T, 32>(p, stream));     \
        case 64: return static_cast<int>(launch_dq_tc<T, 64>(p, stream));     \
        case 80: return static_cast<int>(launch_dq_tc<T, 80>(p, stream));     \
        case 96: return static_cast<int>(launch_dq_tc<T, 96>(p, stream));     \
        case 128: return static_cast<int>(launch_dq_tc<T, 128>(p, stream));   \
        default: return static_cast<int>(cudaErrorInvalidValue);              \
    }
    if (dtype == kBF16) DS_SP_DQ_D(__nv_bfloat16)
    DS_SP_DQ_D(__half)
#undef DS_SP_DQ_D
}
