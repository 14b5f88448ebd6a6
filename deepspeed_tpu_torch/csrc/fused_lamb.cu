// fused_lamb: one LAMB step over flat buffers, in two phases.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/fused_lamb.py
// _lamb_phase1 (line 78) and _lamb_phase2 (line 102), and the per-tensor
// trust ratio taken between them in XLA (lines 169-177).  The buffers are
// the engine's flat fp32 master p, gradient accumulator g and moments m and
// v; a table of chunks stands in for the TPU's [rows, 128] packing.  The
// wrapper (ops/kernels/fused_lamb.py) cuts every tensor segment (one
// parameter leaf: offset and length, any values) into chunks of at most
// 16384 elements (its CHUNK) that never cross a segment boundary:
//   chunk_begin[c], chunk_end[c]  the chunk's element range;
//   chunk_seg[c]                  its segment;
//   seg_first[s] .. seg_first[s + 1]  the chunks of segment s, in order.
// The step's scalars stay on the device: hyper[9] = (lr, beta1, beta2, eps,
// weight_decay, bc1, bc2, max_coeff, min_coeff); gscale (optional)
// multiplies g first (the loss-scale unscale times the clip coefficient);
// skip (optional, the overflow flag) leaves p, m, v and the compute copy
// unwritten and only zeroes g.
//
// fused_lamb_phase1: one CTA per chunk.  m and v take the moment update,
//   g is zeroed, and the raw LAMB update u = (m / bc1) / denom + wd * p is
//   formed (denom = sqrt(v / bc2) + eps, or sqrt(v / bc2 + eps) with
//   eps_inside_sqrt) but not stored: the CTA writes only the chunk's
//   partial sums of p^2 and u^2, each thread's serial sum reduced across
//   the CTA in a fixed tree.
// fused_lamb_phase2: first a CTA per segment sums the segment's chunk
//   partials in a fixed order and writes its trust ratio,
//   clip(|p| / |u|, min_coeff, max_coeff), or 1 where either norm is 0;
//   then one CTA per chunk recomputes u from the new m and v with the same
//   arithmetic as phase 1, writes p -= lr * ratio * u and the compute copy.
// There are no atomics, so a step is bitwise repeatable.
//
// Bound on the H100: no reuse and ~29 FLOPs per element against 46 bytes
// per element with a bf16 copy (phase 1 reads p, g, m, v and writes m, v
// and the zeroed g: 28; phase 2 reads p, m, v and writes p and the copy:
// 18), so the least time is the bytes over 3.35 TB/s.  What the design does
// about them: u is recomputed in phase 2 from m and v instead of stored and
// read back (the same 46 bytes, no 4-byte-per-element scratch buffer), each
// element is read and written with 16-byte accesses by neighbouring threads
// except at a chunk's unaligned ends, and the norms travel as two floats
// per chunk.
#include "common.cuh"

#define DS_LAMB_THREADS 256

struct LambHyper {
    float lr, beta1, beta2, eps, wd, bc1, bc2, gs;
};

__device__ __forceinline__ LambHyper load_hyper(const float* hyper, const float* gscale) {
    return LambHyper{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5], hyper[6],
                     gscale != nullptr ? *gscale : 1.f};
}

// the raw LAMB update from the new moments; phase 1 and phase 2 share it, so
// the u that phase 2 applies is the u whose norm phase 1 took
__device__ __forceinline__ float lamb_update(float p, float m, float v, const LambHyper& hp,
                                             bool eps_in) {
    const float denom = eps_in ? sqrtf(v / hp.bc2 + hp.eps) : sqrtf(v / hp.bc2) + hp.eps;
    return (m / hp.bc1) / denom + hp.wd * p;
}

__device__ __forceinline__ void phase1_elem(float p, float g, float& m, float& v,
                                            const LambHyper& hp, bool eps_in,
                                            float& wsq, float& usq) {
    g = g * hp.gs;
    m = hp.beta1 * m + (1.f - hp.beta1) * g;
    v = hp.beta2 * v + (1.f - hp.beta2) * g * g;
    const float u = lamb_update(p, m, v, hp, eps_in);
    wsq += p * p;
    usq += u * u;
}

// (a, b) summed over the CTA in a fixed order; the result is valid in
// thread 0.  Every thread of the CTA must call it.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
    constexpr int WARPS = DS_LAMB_THREADS / 32;
    __shared__ float2 part[WARPS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) part[warp] = make_float2(a, b);
    __syncthreads();
    float2 r = make_float2(0.f, 0.f);
    if (warp == 0) {
        r = lane < WARPS ? part[lane] : make_float2(0.f, 0.f);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            r.x += __shfl_xor_sync(0xffffffffu, r.x, o);
            r.y += __shfl_xor_sync(0xffffffffu, r.y, o);
        }
    }
    return r;
}

// a chunk [a, e) as a scalar head up to the first multiple of 4, float4
// vectors, and a scalar tail (the buffers' bases are 16-byte aligned)
struct ChunkSplit {
    long long a, a4, n4, t, e;
};

__device__ __forceinline__ ChunkSplit split_chunk(long long a, long long e) {
    long long a4 = (a + 3) & ~3LL;
    if (a4 > e) a4 = e;
    const long long n4 = (e - a4) >> 2;
    return ChunkSplit{a, a4, n4, a4 + 4 * n4, e};
}

__global__ void __launch_bounds__(DS_LAMB_THREADS)
lamb_phase1_kernel(const float* __restrict__ p, float* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, const long long* __restrict__ chunk_begin,
                   const long long* __restrict__ chunk_end, float2* __restrict__ partials,
                   const float* __restrict__ hyper, const float* __restrict__ gscale,
                   const unsigned char* __restrict__ skip, int eps_inside_sqrt) {
    const bool skip_step = skip != nullptr && *skip != 0;
    const LambHyper hp = load_hyper(hyper, gscale);
    const bool eps_in = eps_inside_sqrt != 0;
    const ChunkSplit c = split_chunk(chunk_begin[blockIdx.x], chunk_end[blockIdx.x]);
    float wsq = 0.f, usq = 0.f;
    for (long long i = c.a + threadIdx.x; i < c.a4; i += DS_LAMB_THREADS) {
        if (!skip_step) phase1_elem(p[i], g[i], m[i], v[i], hp, eps_in, wsq, usq);
        g[i] = 0.f;
    }
    const float4* p4 = reinterpret_cast<const float4*>(p + c.a4);
    float4* g4 = reinterpret_cast<float4*>(g + c.a4);
    float4* m4 = reinterpret_cast<float4*>(m + c.a4);
    float4* v4 = reinterpret_cast<float4*>(v + c.a4);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long j = threadIdx.x; j < c.n4; j += DS_LAMB_THREADS) {
        if (!skip_step) {
            const float4 pv = p4[j];
            const float4 gv = g4[j];
            float4 mv = m4[j], vv = v4[j];
            phase1_elem(pv.x, gv.x, mv.x, vv.x, hp, eps_in, wsq, usq);
            phase1_elem(pv.y, gv.y, mv.y, vv.y, hp, eps_in, wsq, usq);
            phase1_elem(pv.z, gv.z, mv.z, vv.z, hp, eps_in, wsq, usq);
            phase1_elem(pv.w, gv.w, mv.w, vv.w, hp, eps_in, wsq, usq);
            m4[j] = mv;
            v4[j] = vv;
        }
        g4[j] = zero;
    }
    for (long long i = c.t + threadIdx.x; i < c.e; i += DS_LAMB_THREADS) {
        if (!skip_step) phase1_elem(p[i], g[i], m[i], v[i], hp, eps_in, wsq, usq);
        g[i] = 0.f;
    }
    const float2 s = block_sum2(wsq, usq);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(DS_LAMB_THREADS)
lamb_trust_kernel(const float2* __restrict__ partials, const long long* __restrict__ seg_first,
                  float* __restrict__ ratio, const float* __restrict__ hyper) {
    const int s = blockIdx.x;
    float w = 0.f, u = 0.f;
    for (long long c = seg_first[s] + threadIdx.x; c < seg_first[s + 1]; c += DS_LAMB_THREADS) {
        const float2 x = partials[c];
        w += x.x;
        u += x.y;
    }
    const float2 t = block_sum2(w, u);
    if (threadIdx.x == 0) {
        const float wn = sqrtf(t.x), un = sqrtf(t.y);
        const float max_coeff = hyper[7], min_coeff = hyper[8];
        ratio[s] = (wn > 0.f && un > 0.f)
                       ? fminf(fmaxf(wn / fmaxf(un, 1e-30f), min_coeff), max_coeff)
                       : 1.f;
    }
}

template <typename T>
__device__ __forceinline__ void phase2_elem(float& p, float m, float v, T* pc, float step,
                                            const LambHyper& hp, bool eps_in) {
    p = p - step * lamb_update(p, m, v, hp, eps_in);
    if (pc != nullptr) *pc = from_float<T>(p);
}

template <typename T>
__global__ void __launch_bounds__(DS_LAMB_THREADS)
lamb_phase2_kernel(float* __restrict__ p, const float* __restrict__ m, const float* __restrict__ v,
                   T* __restrict__ pc, const long long* __restrict__ chunk_begin,
                   const long long* __restrict__ chunk_end, const long long* __restrict__ chunk_seg,
                   const float* __restrict__ ratio, const float* __restrict__ hyper,
                   const unsigned char* __restrict__ skip, int eps_inside_sqrt) {
    if (skip != nullptr && *skip != 0) return;
    const LambHyper hp = load_hyper(hyper, nullptr);
    const bool eps_in = eps_inside_sqrt != 0;
    const float step = hp.lr * ratio[chunk_seg[blockIdx.x]];
    const ChunkSplit c = split_chunk(chunk_begin[blockIdx.x], chunk_end[blockIdx.x]);
    for (long long i = c.a + threadIdx.x; i < c.a4; i += DS_LAMB_THREADS)
        phase2_elem<T>(p[i], m[i], v[i], pc != nullptr ? pc + i : nullptr, step, hp, eps_in);
    float4* p4 = reinterpret_cast<float4*>(p + c.a4);
    const float4* m4 = reinterpret_cast<const float4*>(m + c.a4);
    const float4* v4 = reinterpret_cast<const float4*>(v + c.a4);
    for (long long j = threadIdx.x; j < c.n4; j += DS_LAMB_THREADS) {
        float4 pv = p4[j];
        const float4 mv = m4[j], vv = v4[j];
        phase2_elem<T>(pv.x, mv.x, vv.x, nullptr, step, hp, eps_in);
        phase2_elem<T>(pv.y, mv.y, vv.y, nullptr, step, hp, eps_in);
        phase2_elem<T>(pv.z, mv.z, vv.z, nullptr, step, hp, eps_in);
        phase2_elem<T>(pv.w, mv.w, vv.w, nullptr, step, hp, eps_in);
        p4[j] = pv;
        if (pc != nullptr) store_vec4<T>(pc + c.a4 + 4 * j, pv);
    }
    for (long long i = c.t + threadIdx.x; i < c.e; i += DS_LAMB_THREADS)
        phase2_elem<T>(p[i], m[i], v[i], pc != nullptr ? pc + i : nullptr, step, hp, eps_in);
}

// p, g, m, v: 16-byte aligned fp32 buffers; partials: [n_chunks] float2
// scratch that phase 2 reads.
extern "C" int fused_lamb_phase1(const float* p, float* g, float* m, float* v,
                                 const long long* chunk_begin, const long long* chunk_end,
                                 float* partials, int n_chunks, const float* hyper,
                                 const float* gscale, const unsigned char* skip,
                                 int eps_inside_sqrt, void* stream_ptr) {
    if (n_chunks == 0) return 0;
    lamb_phase1_kernel<<<n_chunks, DS_LAMB_THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        p, g, m, v, chunk_begin, chunk_end, reinterpret_cast<float2*>(partials), hyper, gscale,
        skip, eps_inside_sqrt);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
static cudaError_t launch_phase2(float* p, const float* m, const float* v, void* pc,
                                 const long long* chunk_begin, const long long* chunk_end,
                                 const long long* chunk_seg, const float* ratio, int n_chunks,
                                 const float* hyper, const unsigned char* skip,
                                 int eps_inside_sqrt, cudaStream_t stream) {
    lamb_phase2_kernel<T><<<n_chunks, DS_LAMB_THREADS, 0, stream>>>(
        p, m, v, static_cast<T*>(pc), chunk_begin, chunk_end, chunk_seg, ratio, hyper, skip,
        eps_inside_sqrt);
    return cudaGetLastError();
}

// pc may be null (no compute copy); pc_dtype is its dtype code, and pc
// must be aligned to 4 of its elements.  ratio: [n_seg] fp32 scratch.
extern "C" int fused_lamb_phase2(float* p, const float* m, const float* v, void* pc, int pc_dtype,
                                 const long long* chunk_begin, const long long* chunk_end,
                                 const long long* chunk_seg, const long long* seg_first,
                                 int n_seg, const float* partials, float* ratio, int n_chunks,
                                 const float* hyper, const unsigned char* skip,
                                 int eps_inside_sqrt, void* stream_ptr) {
    if (n_chunks == 0) return 0;
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    lamb_trust_kernel<<<n_seg, DS_LAMB_THREADS, 0, stream>>>(
        reinterpret_cast<const float2*>(partials), seg_first, ratio, hyper);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (pc_dtype) {
        case kF32: return static_cast<int>(launch_phase2<float>(p, m, v, pc, chunk_begin, chunk_end, chunk_seg, ratio, n_chunks, hyper, skip, eps_inside_sqrt, stream));
        case kF16: return static_cast<int>(launch_phase2<__half>(p, m, v, pc, chunk_begin, chunk_end, chunk_seg, ratio, n_chunks, hyper, skip, eps_inside_sqrt, stream));
        case kBF16: return static_cast<int>(launch_phase2<__nv_bfloat16>(p, m, v, pc, chunk_begin, chunk_end, chunk_seg, ratio, n_chunks, hyper, skip, eps_inside_sqrt, stream));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
