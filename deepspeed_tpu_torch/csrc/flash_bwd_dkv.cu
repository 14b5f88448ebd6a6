// flash_bwd_dkv: dK and dV of the flash-attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd_dkv_kernel (line 304) in its two-kernel form (emit_dq=False):
// dV = sum_q round_T(p)^T.dO and dK = sum_q dS^T.Q over the queries that
// see each key, with p and dS recomputed from the saved lse and delta
// (flash_bwd.cuh).  dQ comes from flash_bwd_dq's separate sweep.  Its
// use_window option (:339-341, 357-358, 376-379) is a launch argument, 0
// for none, so one build serves GPT-Neo's banded and global layers.
//
// Bound on the H100: 8*D FLOPs per visible pair against the bytes of q,
// k, v, dO, lse and delta read once and dK, dV written once; at the
// training slice's shape (B 16, S 1024, H 16, D 64, causal) that is about
// 340 FLOPs per byte, above the card's 295 bf16 FLOPs per byte, so the
// least time is the operations over 989 TFLOP/s.
//
// bf16 and fp16 (flash_bwd_dkv_tc): the Hopper design.  One CTA owns a
// (b, h, 128-key) tile: two consumer warpgroups of 64 keys and a producer
// warp.  K and V are loaded once with TMA; the q-tiles of Q and dO (64
// rows, 32 in the tile of 128) stream through a ring of shared-memory
// stages guarded by full and empty mbarriers, from the first q-tile at or
// below the causal frontier to the end.  The producer warp's lanes copy each
// q-tile's lse (times log2 e) and delta into its stage, loaded one tile
// ahead so their latency hides behind the wait for a free stage.  Per
// q-tile each consumer runs the step it shares with
// block_sparse_bwd_dkv_tc (attn_tc.cuh dkv_step: S^T = K.Q^T and
// dP^T = V.dO^T, then dV += round_T(P^T).dO and dK += dS^T.Q, all on
// wgmma with fp32 accumulators); only q-tiles that cross the causal,
// key-length or Sq edge are masked.  Key tiles wholly past the key length
// write zeros and load nothing.  No atomics: one CTA writes each dK and dV element
// once, so the gradients are bitwise repeatable.  Low key tiles see the
// most queries under causal masking and are scheduled first (the key-tile
// index is the grid's slowest dimension).
//
// Under a band (flash_bwd_dkv_tc<T, D, true>, built apart so that the
// causal kernel keeps its loop) the q-tile walk ends at the last row that
// still sees the CTA's last key, k0 + 127 - off + window - 1, so a key
// tile reads about 12 q-tiles of 32 rows (D 128, window 256) wherever it
// sits; each warpgroup computes only the q-tiles its own 64 keys are seen
// by and frees the others once they land, and only q-tiles that cross the
// band's lower edge, the diagonal or the key length are masked (queries
// past Sq arrive as zeros with lse and delta 0 and add exactly 0).
//
// fp32 keeps the FMA kernel below (flash_dkv_fma): a CTA of 128 threads
// per (b, h, k-tile), a key row on TPR = DT/16 lanes, each q-tile widened
// to fp32 in shared memory and reused by all key rows; under a band its
// q-tile walk ends where the tile's last key leaves the band.
//
// Head dims 32, 64, 128, and 80 and 96 (GPT-2 2.7B, 760M) in the tile of
// DT = 128 (common.cuh tile_dim): the tensor-core kernel's S^T and dP^T
// stop at D's last 16-column step, dK and dV are computed over the padded
// columns (zeros TMA fills into Q and dO) and stored below D only; the
// FMA kernel pads its rows with zeros.
#include "attn_tc.cuh"
#include "flash_bwd.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(DS_BWD_THREADS)
flash_dkv_fma(const BwdArgs a) {
    constexpr int DT = HeadDim<D>::TILE;          // the padded row
    constexpr int TPR = DT / 16;                  // lanes per key row
    constexpr int BK = DS_BWD_THREADS / TPR;      // key rows per CTA
    constexpr int BQ = DT <= 64 ? 64 : 32;        // query rows per q-tile
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 qs[BQ][DT / 4];
    __shared__ float4 dos[BQ][DT / 4];
    __shared__ float lses[BQ];
    __shared__ float deltas[BQ];

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int t = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int k0 = blockIdx.x * BK;
    const int kj = k0 + r;
    const int klim = key_limit(a, b);             // keys at or past it are padding
    // a live key; padding keys load nothing and keep dK = dV = 0
    const bool key_ok = kj < klim;
    const int off = a.Sk - a.Sq;
    // the first query that sees any key of this tile is k0 - off; a tile
    // of padding keys only skips the loop and writes zeros
    int qstart = a.causal ? max(0, k0 - off) : 0;
    qstart = k0 >= klim ? a.Sq : (qstart / BQ) * BQ;
    // under a band the walk ends past the last query that sees the tile's
    // last key: q-tiles above every key's band are never loaded
    const bool band = banded(a);
    const int qend = band ? min(a.Sq, max(0, k0 + BK - 1 - off + a.window)) : a.Sq;

    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + (long long)kj * a.k_ss + h * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + (long long)kj * a.v_ss + h * a.v_sh;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long stat0 = ((long long)b * a.H + h) * a.Sq;

    float4 k[NCH], v[NCH], dk[NCH], dv[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const bool ok = key_ok && (c * TPR + t) * 4 < D;   // the padded columns: zero
        k[c] = ok ? load4(kp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[c] = ok ? load4(vp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

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
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                axpy4(dv[c], pr, dov[c]);
                axpy4(dk[c], ds, qv[c]);
            }
        }
    }

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
static cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
    constexpr int BK = DS_BWD_THREADS / (HeadDim<D>::TILE / 16);
    const dim3 grid((a.Sk + BK - 1) / BK, a.H, a.B);
    flash_dkv_fma<T, D><<<grid, DS_BWD_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

namespace {

constexpr int DKV_BK = 128;        // keys per CTA: two warpgroups of 64
constexpr int DKV_THREADS = 288;   // two consumer warpgroups and the producer warp

struct DkvParams {
    CUtensorMap k, v;              // rows of 128 per box
    CUtensorMap q, dout;           // rows of BQ per box
    const float* lse; const float* delta;   // [B, H, Sq]
    void* dk; void* dv;
    const int* kv_lens;
    int Sq, Sk, H;
    long long dk_sb, dk_ss, dk_sh;
    long long dv_sb, dv_ss, dv_sh;
    float scale;
    int causal;
    int window;                    // band width (causal only), 0: none
};

template <int D>
struct DkvCfg : attn_tc::Boxes<D> {
    using attn_tc::Boxes<D>::HALVES;
    using attn_tc::Boxes<D>::ROWB;
    static constexpr int BQ = D > 64 ? 32 : 64;             // queries per q-tile
    static constexpr int STAGES = D > 64 ? 2 : 3;
    static constexpr int K_BYTES = HALVES * DKV_BK * ROWB;  // one of K, V
    static constexpr int T_BYTES = HALVES * BQ * ROWB;      // one of Q, dO
    static constexpr int TILE_OFF = 2 * K_BYTES;            // stage s: Q, then dO
    static constexpr int STAT_OFF = TILE_OFF + STAGES * 2 * T_BYTES;   // stage s: lse, then delta
    static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

// BANDED: causal with a window (built apart, so that the causal kernel
// keeps its loop: both warpgroups on every q-tile to the end)
template <typename T, int D, bool BANDED>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_tc(const __grid_constant__ DkvParams p) {
    using C = DkvCfg<D>;
    constexpr int BQ = C::BQ;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    uint64_t* full = kv_bar + 1;
    uint64_t* empty = full + C::STAGES;

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int k0 = blockIdx.z * DKV_BK;
    const int klim = p.kv_lens != nullptr ? min(p.Sk, max(1, p.kv_lens[b])) : p.Sk;
    T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
    T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
    if (k0 >= klim) {
        // padding keys only: dK = dV = 0, nothing loaded
        const int rows = min(DKV_BK, p.Sk - k0);
        for (int id = threadIdx.x; id < rows * D; id += DKV_THREADS) {
            const long long r = k0 + id / D;
            dkp[r * p.dk_ss + id % D] = from_float<T>(0.f);
            dvp[r * p.dv_ss + id % D] = from_float<T>(0.f);
        }
        return;
    }
    const int off = p.Sk - p.Sq;
    // the first query that sees any key of this tile is k0 - off
    const int qstart = ((p.causal ? max(0, k0 - off) : 0) / BQ) * BQ;
    // under a band the last query that sees any key of this tile is
    // k0 + 127 - off + window - 1 (JAX _band_block_visible); uniform over
    // the CTA, so the producer and both consumers agree
    const int win = BANDED ? p.window : 0;
    const int qend = BANDED ? min(p.Sq, max(0, k0 + DKV_BK - 1 - off + win)) : p.Sq;
    const int nq = qstart < qend ? (qend - qstart + BQ - 1) / BQ : 0;

    if (threadIdx.x == 0) {
        hopper::mbar_init(kv_bar, 1);
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 32);      // the producer warp's lanes
            hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // producer warp: lane 0 issues the TMA loads, every lane copies
        // lse and delta of the q-tile (zeros past Sq) and arrives
        const int lane = threadIdx.x - 256;
        if (nq == 0) return;
        if (lane == 0) {
            hopper::mbar_expect_tx(kv_bar, 2 * C::K_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf) {
                hopper::tma_load_4d(smem + hf * DKV_BK * C::ROWB, &p.k, kv_bar, hf * 64, h, k0, b);
                hopper::tma_load_4d(smem + C::K_BYTES + hf * DKV_BK * C::ROWB, &p.v, kv_bar, hf * 64, h, k0, b);
            }
        }
        // lse (times log2 e, as the consumers' exponentials take it) and
        // delta of q-tile i, fetched one tile ahead so the loads' latency
        // hides behind the wait for a free stage
        constexpr int PER_LANE = BQ / 32;
        const long long stat0 = ((long long)b * p.H + h) * p.Sq;
        float lse_r[PER_LANE], delta_r[PER_LANE];
        auto fetch = [&](int q0) {
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int q = q0 + lane + 32 * j;
                const bool ok = q < p.Sq;
                lse_r[j] = ok ? p.lse[stat0 + q] * hopper::LOG2E : 0.f;
                delta_r[j] = ok ? p.delta[stat0 + q] : 0.f;
            }
        };
        fetch(qstart);
        for (int i = 0; i < nq; ++i) {
            const int s = i % C::STAGES;
            const int q0 = qstart + i * BQ;
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
            if (i + 1 < nq) fetch(q0 + BQ);
        }
        return;
    }

    // consumer warpgroup wg: keys kw .. kw + 63
    const int t = threadIdx.x % 128;
    const hopper::Frag fr(t);
    const int kw = k0 + 64 * wg;
    const int kj[2] = {kw + fr.row, kw + fr.row + 8};
    attn_tc::DkvAcc<D> acc;
    acc.init();
    const uint32_t k_addr = hopper::smem_u32(smem) + 64 * wg * C::ROWB;
    const uint32_t v_addr = k_addr + C::K_BYTES;
    const int Sq = p.Sq;
    const bool causal = p.causal;

    // under a band, this warpgroup's own q-tiles [i_lo, i_hi) of [0, nq):
    // from the tile of the first query that sees its first key to the tile
    // of the last query that sees its last key, none if its keys are all
    // padding.  The bounds go through a shuffle so that ptxas sees them
    // warp-uniform and keeps the wgmma loop free of divergence.
    int i_lo = 0, i_hi = nq;
    if constexpr (BANDED) {
        const int last_row = kw + 63 - off + win - 1;
        const int lo = min(nq, max(0, kw - off - qstart) / BQ);
        i_hi = __shfl_sync(0xffffffffu, kw >= klim || last_row < qstart ? lo
                           : max(lo, min(nq, (last_row - qstart) / BQ + 1)), 0);
        i_lo = __shfl_sync(0xffffffffu, lo, 0);
    }
    // a q-tile this warpgroup skips: freed once its data has landed, so
    // that the arrival cannot count toward the stage's previous tile,
    // which the other warpgroup may still be reading
    auto release = [&](int i) {
        const int s = i % C::STAGES;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    };
    // the band's mask, fixed over the loop (few live registers: the
    // dK/dV kernels run at their register cap): key r = kj[0] + 8r is seen
    // by the w[r] queries from a + 8r (w[r] = 0 for a padding key), and a
    // q-tile at q0 crosses an edge unless q_diag <= q0 < q_band and no key
    // of the warpgroup is padding.  Queries past Sq need no mask: their Q
    // and dO are TMA's zero fill and their lse and delta 0, so they add
    // exactly 0 to dK and dV.
    int a = 0, w[2] = {0, 0}, q_diag = 0, q_band = 0;
    bool edge = false;
    if constexpr (BANDED) {
        a = kj[0] - off;
#pragma unroll
        for (int r = 0; r < 2; ++r) w[r] = kj[r] < klim ? win : 0;
        q_diag = kw + 63 - off;
        q_band = kw - off + win - BQ + 1;
        edge = kw + 64 > klim;
    }
    for (int i = 0; i < i_lo; ++i) release(i);
    if (nq > 0) hopper::mbar_wait(kv_bar, 0);
    for (int i = i_lo; i < i_hi; ++i) {
        const int s = i % C::STAGES;
        const int q0 = qstart + i * BQ;
        hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
        const uint32_t q_addr = hopper::smem_u32(smem + C::TILE_OFF + s * 2 * C::T_BYTES);
        const float* lse_s = reinterpret_cast<const float*>(smem + C::STAT_OFF + s * 2 * BQ * 4);
        if constexpr (BANDED) {
            // only q-tiles that cross the causal, key-length or band edge
            // are masked: the band's when the tile's last query is window
            // or more past the warpgroup's first key
            const bool crosses = edge | (q0 < q_diag) | (q0 >= q_band);
            attn_tc::dkv_step<T, D, DKV_BK, BQ>(acc, fr, k_addr, v_addr, q_addr, q_addr + C::T_BYTES, lse_s,
                                                lse_s + BQ, p.scale, crosses, [=](int r, int c) {
                                                    return static_cast<unsigned>(q0 + c - a - 8 * r) <
                                                           static_cast<unsigned>(w[r]);
                                                });
        } else {
            // only q-tiles that cross the causal, key-length or Sq edge are masked
            const bool crosses = (p.causal && kw + 63 > q0 + off) || kw + 64 > klim || q0 + BQ > p.Sq;
            attn_tc::dkv_step<T, D, DKV_BK, BQ>(acc, fr, k_addr, v_addr, q_addr, q_addr + C::T_BYTES, lse_s,
                                                lse_s + BQ, p.scale, crosses, [=](int r, int c) {
                                                    const int key = kj[r];
                                                    const int qi = q0 + c;
                                                    return (key < klim) & (qi < Sq) & (!causal | (key <= qi + off));
                                                });
        }
        if ((t & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    for (int i = i_hi; i < nq; ++i) release(i);
    attn_tc::dkv_finish<T, D>(acc, fr, dkp, p.dk_ss, dvp, p.dv_ss, kw, p.Sk);
}

template <typename T, int D, bool BANDED>
cudaError_t launch_dkv_tc(const BwdArgs& a, int dtype, cudaStream_t stream) {
    using C = DkvCfg<D>;
    DkvParams p{};
    cudaError_t err = hopper::map_rows(&p.k, a.k, dtype, a.B, a.Sk, a.H, D, a.k_sb, a.k_ss, a.k_sh, DKV_BK);
    if (err == cudaSuccess) err = hopper::map_rows(&p.v, a.v, dtype, a.B, a.Sk, a.H, D, a.v_sb, a.v_ss, a.v_sh, DKV_BK);
    // with no queries nothing but K and V would be loaded, and not even
    // those: every key tile writes zeros
    if (a.Sq > 0) {
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.q, a.q, dtype, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, a.q_sh, C::BQ);
        if (err == cudaSuccess)
            err = hopper::map_rows(&p.dout, a.dout, dtype, a.B, a.Sq, a.H, D, a.do_sb, a.do_ss, a.do_sh, C::BQ);
    }
    if (err != cudaSuccess) return err;
    p.lse = a.lse; p.delta = a.delta;
    p.dk = a.dk; p.dv = a.dv; p.kv_lens = a.kv_lens;
    p.Sq = a.Sq; p.Sk = a.Sk; p.H = a.H;
    p.dk_sb = a.dk_sb; p.dk_ss = a.dk_ss; p.dk_sh = a.dk_sh;
    p.dv_sb = a.dv_sb; p.dv_ss = a.dv_ss; p.dv_sh = a.dv_sh;
    p.scale = a.scale; p.causal = a.causal; p.window = a.window;
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_bwd_dkv_tc<T, D, BANDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(a.H, a.B, (a.Sk + DKV_BK - 1) / DKV_BK);
    flash_bwd_dkv_tc<T, D, BANDED><<<grid, DKV_THREADS, C::SMEM, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_tc(const BwdArgs& a, int dtype, cudaStream_t stream) {
    return banded(a) ? launch_dkv_tc<T, D, true>(a, dtype, stream) : launch_dkv_tc<T, D, false>(a, dtype, stream);
}

}  // namespace

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* kv_lens,
                             void* dk, void* dv, int dtype, int B, int Sq, int Sk, int H, int D,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long do_sb, long long do_ss, long long do_sh,
                             long long dk_sb, long long dk_ss, long long dk_sh,
                             long long dv_sb, long long dv_ss, long long dv_sh,
                             float scale, int causal, int window, void* stream_ptr) {
    if (B == 0 || Sk == 0 || H == 0) return 0;
    BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
              0, 0, 0, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, causal, kv_lens, window};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define DS_DKV_D(T, LAUNCH, ...)                                        \
    switch (D) {                                                         \
        case 32: return static_cast<int>(LAUNCH<T, 32>(a, ##__VA_ARGS__, stream));   \
        case 64: return static_cast<int>(LAUNCH<T, 64>(a, ##__VA_ARGS__, stream));   \
        case 80: return static_cast<int>(LAUNCH<T, 80>(a, ##__VA_ARGS__, stream));   \
        case 96: return static_cast<int>(LAUNCH<T, 96>(a, ##__VA_ARGS__, stream));   \
        case 128: return static_cast<int>(LAUNCH<T, 128>(a, ##__VA_ARGS__, stream)); \
        default: return static_cast<int>(cudaErrorInvalidValue);        \
    }
    switch (dtype) {
        case kF32: DS_DKV_D(float, launch_dkv)
        case kF16: DS_DKV_D(__half, launch_dkv_tc, dtype)
        case kBF16: DS_DKV_D(__nv_bfloat16, launch_dkv_tc, dtype)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DS_DKV_D
}
