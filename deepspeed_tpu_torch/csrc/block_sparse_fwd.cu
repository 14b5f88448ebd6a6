// block_sparse_fwd: block-sparse attention forward with the fp32 logsumexp.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _fwd_kernel (line 107): online-softmax attention over the live blocks of
// a per-head layout only (block_sparse.cuh), positional causal mask inside
// each live block, fp32 accumulation, p rounded to the input dtype before
// P.V, O and the fp32 lse [B, H, S] written.  A row with no live block (or,
// with a layout that allows it, no visible key) keeps m = -inf and l = 0
// and ends with O = 0 and lse = -inf, the JAX kernel's finalize.
//
// One CTA owns `rows` query rows of one q-block and sweeps the ascending
// live k-blocks of its (head, q-block) row of the table, each in chunks of
// KC keys.  Under causal masking a live block's keys past the tile's last
// query are never loaded.  Each chunk of K and V is read from device memory
// once per CTA, widened to fp32 in shared memory and reused by every row of
// the tile; scores, the softmax state and the output accumulator stay in
// registers.
//
// Bound on the H100: 4*D FLOPs per live (q, k) pair against the bytes of
// q, k, v, O and lse.  At the training slice's shape (GPT-2 350M, S 4096,
// Fixed layout, block 64) that is about 0.04 ms either way.  This first
// version multiplies on fp32 FMAs, not tensor cores, and is bound by their
// issue rate, far above that; what its design does about the bytes: dead
// blocks cost neither loads nor FLOPs, and the S x S scores never exist in
// device memory.
#include "block_sparse.cuh"

template <typename T, int D, int KC>
__global__ void __launch_bounds__(DS_SPARSE_THREADS)
block_sparse_fwd_kernel(const SparseArgs a) {
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
    float4 q[NCH], acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        q[c] = load4(qp + (c * TPR + t) * 4);
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
            stage_rows<T, D, KC>(ks, a.k, b, h, k0);
            stage_rows<T, D, KC>(vs, a.v, b, h, k0);
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

extern "C" int block_sparse_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                const int* idx, const int* cnt,
                                int dtype, int B, int S, int H, int D, int block, int width,
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
    DS_SPARSE_DISPATCH(launch_fwd)
}
