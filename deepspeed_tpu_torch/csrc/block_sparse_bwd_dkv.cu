// block_sparse_bwd_dkv: dK and dV of the block-sparse attention backward.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _bwd_dkv_kernel (line 229): dV = sum_q round_T(p)^T.dO and dK = sum_q
// dS^T.Q over the live queries that see each key, with p and dS recomputed
// from the saved lse and delta as in block_sparse_bwd_dq.cu.
//
// One CTA owns `rows` key rows of one k-block and sweeps the ascending live
// q-blocks of its (head, k-block) column of the transposed tables
// (block_sparse.cuh), each in chunks of QC queries; under causal masking the
// chunks that end before the tile's first key are skipped.  A key row is
// held by TPR = D/16 lanes with its fp32 dK and dV accumulators in
// registers, written once at the end: each output element comes from one
// CTA, with no atomics, so runs are bitwise repeatable.  Each chunk of Q,
// dO, lse and delta is read from device memory once per CTA and shared by
// every key row in shared memory.  Per live pair the kernel does 4*D FMAs
// (s = k.q, dP = v.dO, dV += p*dO, dK += dS*q).
//
// Load imbalance: the CTA of a global stripe's column visits every later
// q-block (up to n), the others a handful; the longest CTAs set the
// kernel's tail.
//
// Bound on the H100: 8*D FLOPs per live pair against the bytes of q, k, v,
// dO, lse and delta read once and dK, dV written once.  This first version
// multiplies on fp32 FMAs, not tensor cores, and is bound by their issue
// rate, far above that.
#include "block_sparse.cuh"

template <typename T, int D, int QC>
__global__ void __launch_bounds__(DS_SPARSE_THREADS)
block_sparse_bwd_dkv_kernel(const SparseArgs a) {
    constexpr int TPR = D / 16;                   // lanes per key row
    constexpr int NCH = 4;                        // float4 chunks per lane
    __shared__ float4 qs[QC][D / 4];
    __shared__ float4 dos[QC][D / 4];
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
        k[c] = load4(kp + (c * TPR + t) * 4);
        v[c] = load4(vp + (c * TPR + t) * 4);
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
            stage_rows<T, D, QC>(qs, a.q, b, h, q0);
            stage_rows<T, D, QC>(dos, a.dout, b, h, q0);
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

extern "C" int block_sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                    float* lse, const float* delta, void* dk, void* dv,
                                    const int* idxT, const int* cntT,
                                    int dtype, int B, int S, int H, int D, int block, int width,
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
    DS_SPARSE_DISPATCH(launch_dkv)
}
