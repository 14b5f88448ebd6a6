// flash_bwd_dkv: dK and dV of the flash-attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd_dkv_kernel (line 304) in its two-kernel form (emit_dq=False):
// dV = sum_q round_T(p)^T.dO and dK = sum_q dS^T.Q over the queries that
// see each key, with p and dS recomputed from the saved lse and delta
// (flash_bwd.cuh).  dQ comes from flash_bwd_dq's separate sweep.
//
// One CTA of 128 threads owns a (b, h, k-tile) and walks the q-tiles from
// the first one at or below the causal frontier (end-aligned: query i sees
// key j iff j <= i + Sk - Sq) to the end.  A key row is held by TPR = D/16
// neighbouring lanes, each owning four float4 chunks of k, v and of the
// fp32 dK and dV accumulators, which are written once at the end.  Each
// q-tile of Q, dO, lse and delta is loaded from device memory once,
// widened to fp32 in shared memory (32 KB or less, static) and reused by
// all BK key rows; a warp's reads of one query row broadcast to every key
// row of the warp.  Per visible pair the kernel does 4*D FMAs (s = k.q,
// dP = v.dO, dV += p*dO, dK += dS*q); the loops over queries are
// CTA-uniform, so the full-mask shuffles never diverge.
//
// Bound on the H100: 8*D FLOPs per visible pair against the bytes of q,
// k, v, dO, lse and delta read once and dK, dV written once; at the
// training slice's shape (B 16, S 1024, H 16, D 64, causal) that is about
// 340 FLOPs per byte, above the card's 295 bf16 FLOPs per byte, so the
// least time is the operations over 989 TFLOP/s.  This first version
// multiplies on fp32 FMAs, not tensor cores, and is bound by their issue
// rate, far above that.
#include "flash_bwd.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(DS_BWD_THREADS)
flash_bwd_dkv_kernel(const BwdArgs a) {
    constexpr int TPR = D / 16;                   // lanes per key row
    constexpr int BK = DS_BWD_THREADS / TPR;      // key rows per CTA
    constexpr int BQ = D <= 64 ? 64 : 32;         // query rows per q-tile
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 qs[BQ][D / 4];
    __shared__ float4 dos[BQ][D / 4];
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

    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + (long long)kj * a.k_ss + h * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + (long long)kj * a.v_ss + h * a.v_sh;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long stat0 = ((long long)b * a.H + h) * a.Sq;

    float4 k[NCH], v[NCH], dk[NCH], dv[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        k[c] = key_ok ? load4(kp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[c] = key_ok ? load4(vp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int q0 = qstart; q0 < a.Sq; q0 += BQ) {
        __syncthreads();                          // the previous tile is consumed
        load_rows<T, D, BQ>(qs, qp, a.q_ss, q0, a.Sq);
        load_rows<T, D, BQ>(dos, dop, a.do_ss, q0, a.Sq);
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
            const bool vis = key_ok && qi < a.Sq && (!a.causal || kj <= qi + off);
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
        store4(dkp + (c * TPR + t) * 4, dk[c].x, dk[c].y, dk[c].z, dk[c].w);
        store4(dvp + (c * TPR + t) * 4, dv[c].x, dv[c].y, dv[c].z, dv[c].w);
    }
}

template <typename T, int D>
static cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
    constexpr int BK = DS_BWD_THREADS / (D / 16);
    const dim3 grid((a.Sk + BK - 1) / BK, a.H, a.B);
    flash_bwd_dkv_kernel<T, D><<<grid, DS_BWD_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* kv_lens,
                             void* dk, void* dv, int dtype, int B, int Sq, int Sk, int H, int D,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long do_sb, long long do_ss, long long do_sh,
                             long long dk_sb, long long dk_ss, long long dk_sh,
                             long long dv_sb, long long dv_ss, long long dv_sh,
                             float scale, int causal, void* stream_ptr) {
    if (B == 0 || Sk == 0 || H == 0) return 0;
    BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
              0, 0, 0, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, causal, kv_lens};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    DS_BWD_DISPATCH(launch_dkv)
}
