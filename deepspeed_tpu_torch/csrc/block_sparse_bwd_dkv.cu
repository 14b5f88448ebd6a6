// block_sparse_bwd_dkv: dK and dV of the block-sparse attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _bwd_dkv_kernel (line 229): dV = sum_q round_T(p)^T.dO and dK = sum_q
// dS^T.Q over the live queries that see each key, with p and dS recomputed
// from the saved lse and delta as in block_sparse_bwd_dq.cu
// (dS = round_T(p * (dP - delta) * scale)).  Each output element is
// written once by one CTA, with no atomics, so runs are bitwise
// repeatable.
//
// Bound on the H100: 8*D FLOPs per live pair against the bytes of q, k, v,
// dO, lse and delta read once and dK, dV written once.
//
// bf16 and fp16 (block_sparse_bwd_dkv_tc): the Hopper design, over the
// transposed tile table (block_sparse.cuh).  One CTA owns a (b, h, 64-key
// tile) unit, the units launched heaviest column first (a global stripe's
// column sees every later q-tile, the others a handful, so the long CTAs
// start first instead of ending the grid as its tail): one consumer
// warpgroup and a producer warp.  K and V are loaded once with TMA; the
// live q-tiles of Q and dO stream through a ring of shared-memory stages
// (64 queries a stage, 32 at D 128, whose two halves then take two
// stages, to keep the accumulators in registers), and the producer warp's
// lanes copy each stage's lse (times log2 e) and delta with plain loads,
// fetched one stage ahead.  The consumer runs flash_bwd_dkv_tc's step
// (attn_tc.cuh dkv_step) and masks, by selects, only the partial tiles:
// sub-blocks not all live (blocks 16 and 32) or the causal diagonal tile.
// A key tile no live query sees writes dK = dV = 0 and loads nothing.
//
// fp32 keeps the FMA kernel below: one CTA per `rows` key rows of one
// k-block, sweeping the live q-blocks of its column of the transposed
// block table in chunks of QC queries staged in shared memory as fp32, a
// key row on TPR = D/16 lanes with its fp32 dK and dV in registers; under
// causal masking the chunks that end before the tile's first key are
// skipped.  It is bound by the FMA issue rate.
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// 128 (common.cuh tile_dim), with D 128's stages ("D 128" above): S^T and
// dP^T stop at D's last 16-column step, dK and dV are computed over the
// padded columns (zeros TMA fills into Q and dO) and stored below D only;
// the FMA kernel pads its rows with zeros (block_sparse.cuh).
#include "attn_tc.cuh"
#include "block_sparse.cuh"

template <typename T, int D, int QC>
__global__ void __launch_bounds__(DS_SPARSE_THREADS)
block_sparse_bwd_dkv_kernel(const SparseArgs a) {
    constexpr int DT = HeadDim<D>::TILE;          // the padded row
    constexpr int TPR = DT / 16;                  // lanes per key row
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 qs[QC][DT / 4];
    __shared__ float4 dos[QC][DT / 4];
    __shared__ float lses[QC];
    __shared__ float deltas[QC];

    const int rows = blockDim.x / TPR;
    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int t = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int k0 = blockIdx.x * rows;
    const int kj = k0 + r;
    const int n = a.S / a.block;
    const int kb = k0 / a.block;
    const int* live = a.idx + ((long long)h * n + kb) * a.width;
    const int count = a.cnt[h * n + kb];
    const long long stat0 = ((long long)b * a.H + h) * a.S;

    const T* kp = row_ptr<T>(a.k, b, kj, h);
    const T* vp = row_ptr<T>(a.v, b, kj, h);
    float4 k[NCH], v[NCH], dk[NCH], dv[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const bool ok = (c * TPR + t) * 4 < D;    // the padded columns: zero
        k[c] = ok ? load4(kp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[c] = ok ? load4(vp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int jb = 0; jb < count; ++jb) {
        int q_first = live[jb] * a.block;
        const int q_end = q_first + a.block;
        // queries before the tile's first key see none of it
        if (a.causal) q_first = max(q_first, (k0 / QC) * QC);
        for (int q0 = q_first; q0 < q_end; q0 += QC) {
            __syncthreads();                      // the previous chunk is consumed
            stage_rows<T, D, QC, DT>(qs, a.q, b, h, q0);
            stage_rows<T, D, QC, DT>(dos, a.dout, b, h, q0);
            for (int i = tid; i < QC; i += blockDim.x) {
                lses[i] = a.lse[stat0 + q0 + i];
                deltas[i] = a.delta[stat0 + q0 + i];
            }
            __syncthreads();
#pragma unroll 2
            for (int i = 0; i < QC; ++i) {
                float4 qv[NCH], dov[NCH];
                float s = 0.f, dp = 0.f;
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    qv[c] = qs[i][c * TPR + t];
                    dov[c] = dos[i][c * TPR + t];
                    s += dot4s(k[c], qv[c]);
                    dp += dot4s(v[c], dov[c]);
                }
#pragma unroll
                for (int o = TPR / 2; o > 0; o >>= 1) {
                    s += __shfl_xor_sync(0xffffffffu, s, o);
                    dp += __shfl_xor_sync(0xffffffffu, dp, o);
                }
                const bool vis = lses[i] > -INFINITY && (!a.causal || kj <= q0 + i);
                float pr = 0.f, ds = 0.f;
                if (vis) {
                    const float p = expf(s * a.scale - lses[i]);
                    pr = round_to<T>(p);
                    ds = round_to<T>(p * (dp - deltas[i]) * a.scale);
                }
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    axpy4s(dv[c], pr, dov[c]);
                    axpy4s(dk[c], ds, qv[c]);
                }
            }
        }
    }

    T* dkp = const_cast<T*>(row_ptr<T>(a.out0, b, kj, h));
    T* dvp = const_cast<T*>(row_ptr<T>(a.out1, b, kj, h));
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        if ((c * TPR + t) * 4 >= D) continue;
        store4(dkp + (c * TPR + t) * 4, dk[c].x, dk[c].y, dk[c].z, dk[c].w);
        store4(dvp + (c * TPR + t) * 4, dv[c].x, dv[c].y, dv[c].z, dv[c].w);
    }
}

template <typename T, int D, int QC>
static cudaError_t launch_dkv(const SparseArgs& a, cudaStream_t stream) {
    dim3 grid, block;
    sparse_grid<D>(a, grid, block);
    block_sparse_bwd_dkv_kernel<T, D, QC><<<grid, block, 0, stream>>>(a);
    return cudaGetLastError();
}

namespace {

constexpr int SP_THREADS = 160;    // one consumer warpgroup and the producer warp
constexpr int SP_TILE = 64;        // keys and queries per tile

struct SpDkvParams {
    CUtensorMap k, v;              // boxes of 64 rows
    CUtensorMap q, dout;           // boxes of BQ rows
    const float* lse; const float* delta;   // [B, H, S]
    void* dk; void* dv;
    TileTable tt;                  // the transposed table
    int B, S, H, nt;
    long long dk_sb, dk_ss, dk_sh;
    long long dv_sb, dv_ss, dv_sh;
    float scale;
    int causal;
    int bl;                        // sub_block_log(block)
};

template <int D>
struct SpDkvCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;
    using attn_tc::Boxes<D>::ROWB;
    static constexpr int BQ = D > 64 ? 32 : 64;             // queries per stage
    static constexpr int NSUB = SP_TILE / BQ;               // stages per q-tile
    static constexpr int STAGES = 3;
    static constexpr int K_BYTES = HALVES * SP_TILE * ROWB; // one of K, V
    static constexpr int T_BYTES = HALVES * BQ * ROWB;      // one of Q, dO
    static constexpr int TILE_OFF = 2 * K_BYTES;            // stage s: Q, then dO
    static constexpr int STAT_OFF = TILE_OFF + STAGES * 2 * T_BYTES;   // stage s: lse, then delta
    static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

template <typename T, int D>
__global__ void __launch_bounds__(SP_THREADS, 2) block_sparse_bwd_dkv_tc(const __grid_constant__ SpDkvParams p) {
    using C = SpDkvCfg<D>;
    constexpr int BQ = C::BQ;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = kv_bar + 1;
    uint64_t* empty = full + C::STAGES;

    const int unit = p.tt.order[blockIdx.x / p.B];    // heaviest columns first
    const int b = blockIdx.x % p.B;
    const int h = unit / p.nt;
    const int kt = unit % p.nt;
    const int k0 = kt * SP_TILE;
    // the loop count of every thread: the unit's live q-tiles, NSUB stages
    // each (a shuffle shows the compiler it is warp-uniform)
    const int steps = __shfl_sync(0xffffffffu, p.tt.cnt[unit], 0) * C::NSUB;
    const int* live = p.tt.entries + (long long)unit * p.tt.width;
    T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
    T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
    const int t = threadIdx.x;

    if (steps == 0) {
        // no live query sees these keys: dK = dV = 0, nothing loaded
        const int rows = min(SP_TILE, p.S - k0);
        for (int id = t; id < rows * D; id += SP_THREADS) {
            const long long r = k0 + id / D;
            dkp[r * p.dk_ss + id % D] = from_float<T>(0.f);
            dvp[r * p.dv_ss + id % D] = from_float<T>(0.f);
        }
        return;
    }

    if (t == 0) {
        hopper::mbar_init(kv_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 32);      // the producer warp's lanes
            hopper::mbar_init(&empty[s], 4);      // one arrival per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (t >= 128) {
        // producer warp: lane 0 issues the TMA loads, every lane copies
        // lse and delta of the stage's queries (zeros past S) and arrives
        const int lane = t - 128;
        if (lane == 0) {
            hopper::mbar_expect_tx(kv_bar, 2 * C::K_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf) {
                hopper::tma_load_4d(smem + hf * SP_TILE * C::ROWB, &p.k, kv_bar, hf * 64, h, k0, b);
                hopper::tma_load_4d(smem + C::K_BYTES + hf * SP_TILE * C::ROWB, &p.v, kv_bar, hf * 64, h, k0, b);
            }
        }
        constexpr int PER_LANE = BQ / 32;
        const long long stat0 = ((long long)b * p.H + h) * p.S;
        float lse_r[PER_LANE], delta_r[PER_LANE];
        auto first_query = [&](int i) { return (live[i / C::NSUB] & 0xffff) * SP_TILE + (i % C::NSUB) * BQ; };
        auto fetch = [&](int q0) {
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int q = q0 + lane + 32 * j;
                const bool ok = q < p.S;
                lse_r[j] = ok ? p.lse[stat0 + q] * hopper::LOG2E : 0.f;
                delta_r[j] = ok ? p.delta[stat0 + q] : 0.f;
            }
        };
        int q0 = first_query(0);
        fetch(q0);
        for (int i = 0; i < steps; ++i) {
            const int s = i % C::STAGES;
            hopper::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
            float* st = reinterpret_cast<float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                st[lane + 32 * j] = lse_r[j];
                st[BQ + lane + 32 * j] = delta_r[j];
            }
            if (lane == 0) {
                // the arrival that completes the phase carries the bytes
                hopper::mbar_expect_tx(&full[s], 2 * C::T_BYTES);
                uint8_t* qs = smem + C::TILE_OFF + s * 2 * C::T_BYTES;
                for (int hf = 0; hf < C::HALVES; ++hf) {
                    hopper::tma_load_4d(qs + hf * BQ * C::ROWB, &p.q, &full[s], hf * 64, h, q0, b);
                    hopper::tma_load_4d(qs + C::T_BYTES + hf * BQ * C::ROWB, &p.dout, &full[s], hf * 64, h, q0, b);
                }
            } else {
                hopper::mbar_arrive(&full[s]);
            }
            if (i + 1 < steps) {
                q0 = first_query(i + 1);
                fetch(q0);
            }
        }
        return;
    }

    // the consumer warpgroup: keys k0 .. k0 + 63
    const hopper::Frag fr(t);
    attn_tc::DkvAcc<D> acc;
    acc.init();
    const int bl = p.bl;
    const unsigned whole = all_live(bl);
    const uint32_t k_addr = hopper::smem_u32(smem);
    hopper::mbar_wait(kv_bar, 0);
    for (int i = 0; i < steps; ++i) {
        const unsigned e = static_cast<unsigned>(live[i / C::NSUB]);
        const unsigned bits = e >> 16;
        const bool diag = p.causal && static_cast<int>(e & 0xffff) == kt;
        const int qoff = (i % C::NSUB) * BQ;      // the stage's first query inside its tile
        const int s = i % C::STAGES;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        const uint32_t q_addr = hopper::smem_u32(smem + C::TILE_OFF + s * 2 * C::T_BYTES);
        const float* lse_s = reinterpret_cast<const float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
        attn_tc::dkv_step<T, D, SP_TILE, BQ>(acc, fr, k_addr, k_addr + C::K_BYTES, q_addr, q_addr + C::T_BYTES,
                                             lse_s, lse_s + BQ, p.scale, diag || bits != whole,
                                             [=](int r, int c) {
                                                 return tile_visible(bits, qoff + c, fr.row + 8 * r, bl, diag);
                                             });
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    attn_tc::dkv_finish<T, D>(acc, fr, dkp, p.dk_ss, dvp, p.dv_ss, k0, p.S);
}

// the TMA maps of K and V (64 rows a box) and of Q and dO (BQ rows), then
// the launch
template <typename T, int D>
cudaError_t launch_dkv_tc(SpDkvParams& p, const SparseArgs& a, int dtype, cudaStream_t stream) {
    using C = SpDkvCfg<D>;
    cudaError_t err = hopper::map_rows(&p.k, a.k.p, dtype, a.B, a.S, a.H, D, a.k.sb, a.k.ss, a.k.sh, SP_TILE);
    if (err == cudaSuccess)
        err = hopper::map_rows(&p.v, a.v.p, dtype, a.B, a.S, a.H, D, a.v.sb, a.v.ss, a.v.sh, SP_TILE);
    if (err == cudaSuccess)
        err = hopper::map_rows(&p.q, a.q.p, dtype, a.B, a.S, a.H, D, a.q.sb, a.q.ss, a.q.sh, C::BQ);
    if (err == cudaSuccess)
        err = hopper::map_rows(&p.dout, a.dout.p, dtype, a.B, a.S, a.H, D, a.dout.sb, a.dout.ss, a.dout.sh, C::BQ);
    if (err != cudaSuccess) return err;
    static const cudaError_t attr =
        cudaFuncSetAttribute(block_sparse_bwd_dkv_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    block_sparse_bwd_dkv_tc<T, D><<<p.B * p.H * p.nt, SP_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int block_sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                    float* lse, const float* delta, void* dk, void* dv,
                                    const int* idxT, const int* cntT,
                                    const int* tilesT, const int* tile_cntT, const int* tile_orderT,
                                    int dtype, int B, int S, int H, int D, int block, int width, int tile_width,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long do_sb, long long do_ss, long long do_sh,
                                    long long dk_sb, long long dk_ss, long long dk_sh,
                                    long long dv_sb, long long dv_ss, long long dv_sh,
                                    float scale, int causal, void* stream_ptr) {
    if (B == 0 || S == 0 || H == 0) return 0;
    SparseArgs a{{q, q_sb, q_ss, q_sh}, {k, k_sb, k_ss, k_sh}, {v, v_sb, v_ss, v_sh},
                 {dout, do_sb, do_ss, do_sh}, {dk, dk_sb, dk_ss, dk_sh}, {dv, dv_sb, dv_ss, dv_sh},
                 lse, delta, idxT, cntT, width, B, S, H, block, scale, causal};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (!sparse_args_ok(a) || tile_width < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF32) DS_SPARSE_D(launch_dkv, float)
    if (dtype != kF16 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    SpDkvParams p{};
    p.lse = lse; p.delta = delta; p.dk = dk; p.dv = dv;
    p.tt = TileTable{tilesT, tile_cntT, tile_orderT, tile_width};
    p.B = B; p.S = S; p.H = H; p.nt = (S + SP_TILE - 1) / SP_TILE;
    p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
    p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
    p.scale = scale; p.causal = causal; p.bl = sub_block_log(block);
#define DS_SP_DKV_D(T)                                                                 \
    switch (D) {                                                                       \
        case 32: return static_cast<int>(launch_dkv_tc<T, 32>(p, a, dtype, stream));   \
        case 64: return static_cast<int>(launch_dkv_tc<T, 64>(p, a, dtype, stream));   \
        case 80: return static_cast<int>(launch_dkv_tc<T, 80>(p, a, dtype, stream));   \
        case 96: return static_cast<int>(launch_dkv_tc<T, 96>(p, a, dtype, stream));   \
        case 128: return static_cast<int>(launch_dkv_tc<T, 128>(p, a, dtype, stream)); \
        default: return static_cast<int>(cudaErrorInvalidValue);                      \
    }
    if (dtype == kBF16) DS_SP_DKV_D(__nv_bfloat16)
    DS_SP_DKV_D(__half)
#undef DS_SP_DKV_D
}
