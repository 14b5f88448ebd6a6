// block_sparse_bwd_dq: dQ of the block-sparse attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _bwd_dq_kernel (line 193): dQ = sum_k dS.K over the live keys each query
// sees, with p = exp(s * scale - lse) recomputed from the forward's fp32
// logsumexp and dS = round_T(p * (dP - delta) * scale), dP = dO.V, delta =
// rowsum(dO * O) precomputed in fp32 [B, H, S] (the JAX kernel's rounding).
// A pair is masked before the exponential, and so is a row whose lse is
// -inf, so no gradient is ever NaN.
//
// The sweep is the forward's (block_sparse.cuh, block_sparse_fwd.cu): one
// CTA owns `rows` query rows of one q-block and walks its row of the table,
// each live block in chunks of KC keys staged once in shared memory as
// fp32.  Per live pair the kernel does 3*D FMAs (s = q.k, dP = dO.v,
// dQ += dS*k).  Each dQ element is written by one CTA, with no atomics.
//
// Bound on the H100: 6*D FLOPs per live pair against the bytes of q, k, v,
// dO, dQ, lse and delta.  It multiplies on fp32 FMAs in every dtype, not
// tensor cores, and is bound by their issue rate, far above that; it reads
// the lse that block_sparse_fwd_tc (bf16, fp16) or the FMA forward (fp32)
// wrote.
#include "block_sparse.cuh"

template <typename T, int D, int KC>
__global__ void __launch_bounds__(DS_SPARSE_THREADS)
block_sparse_bwd_dq_kernel(const SparseArgs a) {
    constexpr int TPR = D / 16;                   // lanes per query row
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 ks[KC][D / 4];
    __shared__ float4 vs[KC][D / 4];

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
        q[c] = load4(qp + (c * TPR + t) * 4);
        dout[c] = load4(dop + (c * TPR + t) * 4);
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
            stage_rows<T, D, KC>(ks, a.k, b, h, k0);
            stage_rows<T, D, KC>(vs, a.v, b, h, k0);
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
        store4(dqp + (c * TPR + t) * 4, acc[c].x, acc[c].y, acc[c].z, acc[c].w);
}

template <typename T, int D, int KC>
static cudaError_t launch_dq(const SparseArgs& a, cudaStream_t stream) {
    dim3 grid, block;
    sparse_grid<D>(a, grid, block);
    block_sparse_bwd_dq_kernel<T, D, KC><<<grid, block, 0, stream>>>(a);
    return cudaGetLastError();
}

extern "C" int block_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                   float* lse, const float* delta, void* dq,
                                   const int* idx, const int* cnt,
                                   int dtype, int B, int S, int H, int D, int block, int width,
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
    DS_SPARSE_DISPATCH(launch_dq)
}
