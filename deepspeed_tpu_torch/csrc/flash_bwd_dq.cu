// flash_bwd_dq: dQ of the flash-attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd_dq_kernel (line 246): dQ = sum_k dS.K over the keys each query sees,
// with dS recomputed from the saved lse and delta (flash_bwd.cuh).
//
// One CTA of 128 threads owns a (b, h, q-tile) and walks the k-tiles up to
// its causal frontier.  A query row is held by TPR = D/16 neighbouring
// lanes, each owning four float4 chunks of q, dO and the dQ accumulator
// (chunk c*TPR + t), the layout of flash_tile.cuh: a warp's reads of a
// shared K or V row broadcast to every row of the warp, with no bank
// conflicts.  Each k-tile is loaded from device memory once, widened to
// fp32 in shared memory and reused by all BQ rows.  Per visible pair the
// kernel does 3*D FMAs (s = q.k, dP = dO.v, dQ += dS*k); the loops over
// keys are CTA-uniform, so the full-mask shuffles that reduce s and dP
// across a row's lanes never diverge.
//
// Bound on the H100: 6*D FLOPs per visible pair against the bytes of q,
// k, v, dO, dQ, lse and delta read or written once; at the training
// slice's shape (B 16, S 1024, H 16, D 64, causal) that is about 300
// FLOPs per byte, just above the card's 295 bf16 FLOPs per byte, so the
// least time is the operations over 989 TFLOP/s.  This first version
// multiplies on fp32 FMAs, not tensor cores, and is bound by their issue
// rate, far above that.
#include "flash_bwd.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(DS_BWD_THREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
    constexpr int TPR = D / 16;                   // lanes per query row
    constexpr int BQ = DS_BWD_THREADS / TPR;      // query rows per CTA
    constexpr int BK = D <= 64 ? 64 : 32;         // keys per k-tile
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 ks[BK][D / 4];
    __shared__ float4 vs[BK][D / 4];

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

    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)qi * a.q_ss + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + (long long)qi * a.do_ss + h * a.do_sh;
    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

    float4 q[NCH], dout[NCH], acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        q[c] = row_ok ? load4(qp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        dout[c] = row_ok ? load4(dop + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const long long stat = ((long long)b * a.H + h) * a.Sq + qi;
    const float lse = row_ok ? a.lse[stat] : 0.f;
    const float delta = row_ok ? a.delta[stat] : 0.f;

    for (int k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();                          // the previous tile is consumed
        load_rows<T, D, BK>(ks, kp, a.k_ss, k0, klim);
        load_rows<T, D, BK>(vs, vp, a.v_ss, k0, klim);
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
            const bool vis = row_ok && kj < klim && (!a.causal || kj <= qi + off);
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
        store4(dqp + (c * TPR + t) * 4, acc[c].x, acc[c].y, acc[c].z, acc[c].w);
}

template <typename T, int D>
static cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
    constexpr int BQ = DS_BWD_THREADS / (D / 16);
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, DS_BWD_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* kv_lens,
                            void* dq, int dtype, int B, int Sq, int Sk, int H, int D,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long do_sb, long long do_ss, long long do_sh,
                            long long dq_sb, long long dq_ss, long long dq_sh,
                            float scale, int causal, void* stream_ptr) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk, H,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
              dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, scale, causal, kv_lens};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    DS_BWD_DISPATCH(launch_dq)
}
