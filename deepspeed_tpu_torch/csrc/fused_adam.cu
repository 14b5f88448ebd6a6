// fused_adam: one Adam/AdamW step over flat buffers.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py
// _adam_kernel (line 29), and with it the engine's boundary update
// (runtime/engine.py apply_core): one elementwise pass that reads the fp32
// master p, the fp32 gradient accumulator g and the fp32 moments m and v,
// and writes p, m, v, the compute-dtype copy of p (the cast at
// engine.py:1225-1228) and a zeroed g.  The step's scalars stay on the
// device, so a schedule or a skipped step never needs the host:
//   hyper[7] = (lr, beta1, beta2, eps, weight_decay, bc1, bc2), the SMEM
//     scalars of the TPU kernel;
//   gscale (optional) multiplies g first: the loss-scale unscale times the
//     global-norm clip coefficient;
//   skip (optional, the overflow flag): when set, p, m, v and the compute
//     copy are not written and only g is zeroed, the jnp.where(overflow,
//     old, new) of engine.py:1221-1224.
//
// Bound on the H100: no reuse, 34 bytes per element in bf16 (16 read, 16
// written in fp32, 2 for the bf16 copy) against ~15 FLOPs: the bytes over
// 3.35 TB/s.  What the design does about them: each element is read and
// written exactly once, with 16-byte loads and stores of neighbouring
// elements by neighbouring threads over a grid-stride loop.
#include "common.cuh"

#define DS_ADAM_THREADS 256
#define DS_ADAM_MAX_BLOCKS 2112   // 16 per SM on 132 SMs

struct AdamHyper {
    float lr, beta1, beta2, eps, wd, bc1, bc2, gs;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          const AdamHyper& hp, bool adam_w) {
    g = g * hp.gs;
    if (!adam_w) g = g + hp.wd * p;
    m = hp.beta1 * m + (1.f - hp.beta1) * g;
    v = hp.beta2 * v + (1.f - hp.beta2) * g * g;
    float update = (m / hp.bc1) / (sqrtf(v / hp.bc2) + hp.eps);
    if (adam_w) update = update + hp.wd * p;
    p = p - hp.lr * update;
}

template <typename T>
__global__ void __launch_bounds__(DS_ADAM_THREADS)
fused_adam_kernel(float* __restrict__ p, float* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, T* __restrict__ pc, const float* __restrict__ hyper,
                  const float* __restrict__ gscale, const unsigned char* __restrict__ skip,
                  long long n, int adam_w_mode) {
    const bool skip_step = skip != nullptr && *skip != 0;
    const AdamHyper hp{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5], hyper[6],
                       gscale != nullptr ? *gscale : 1.f};
    const bool adam_w = adam_w_mode != 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nvec = n / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i = first; i < nvec; i += stride) {
        if (skip_step) {
            reinterpret_cast<float4*>(g)[i] = zero;
            continue;
        }
        float4 pv = reinterpret_cast<const float4*>(p)[i];
        const float4 gv = reinterpret_cast<const float4*>(g)[i];
        float4 mv = reinterpret_cast<const float4*>(m)[i];
        float4 vv = reinterpret_cast<const float4*>(v)[i];
        adam_elem(pv.x, gv.x, mv.x, vv.x, hp, adam_w);
        adam_elem(pv.y, gv.y, mv.y, vv.y, hp, adam_w);
        adam_elem(pv.z, gv.z, mv.z, vv.z, hp, adam_w);
        adam_elem(pv.w, gv.w, mv.w, vv.w, hp, adam_w);
        reinterpret_cast<float4*>(p)[i] = pv;
        reinterpret_cast<float4*>(m)[i] = mv;
        reinterpret_cast<float4*>(v)[i] = vv;
        reinterpret_cast<float4*>(g)[i] = zero;
        if (pc != nullptr) store_vec4<T>(pc + 4 * i, pv);
    }
    // the n % 4 elements past the last full vector
    for (long long i = nvec * 4 + first; i < n; i += stride) {
        if (!skip_step) {
            adam_elem(p[i], g[i], m[i], v[i], hp, adam_w);
            if (pc != nullptr) pc[i] = from_float<T>(p[i]);
        }
        g[i] = 0.f;
    }
}

template <typename T>
static cudaError_t launch_adam(float* p, float* g, float* m, float* v, void* pc,
                               const float* hyper, const float* gscale,
                               const unsigned char* skip, long long n, int adam_w_mode,
                               cudaStream_t stream) {
    const long long nvec = n / 4 > 0 ? n / 4 : 1;
    const long long want = (nvec + DS_ADAM_THREADS - 1) / DS_ADAM_THREADS;
    const int blocks = static_cast<int>(want < DS_ADAM_MAX_BLOCKS ? want : DS_ADAM_MAX_BLOCKS);
    fused_adam_kernel<T><<<blocks, DS_ADAM_THREADS, 0, stream>>>(
        p, g, m, v, static_cast<T*>(pc), hyper, gscale, skip, n, adam_w_mode);
    return cudaGetLastError();
}

// pc may be null (no compute copy: the master is the model's own fp32
// params); pc_dtype is its dtype code.  p, g, m, v and pc must be 16-byte
// aligned (8-byte for a 16-bit pc).
extern "C" int fused_adam(float* p, float* g, float* m, float* v, void* pc, int pc_dtype,
                          const float* hyper, const float* gscale, const unsigned char* skip,
                          long long n, int adam_w_mode, void* stream_ptr) {
    if (n == 0) return 0;
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (pc_dtype) {
        case kF32: return static_cast<int>(launch_adam<float>(p, g, m, v, pc, hyper, gscale, skip, n, adam_w_mode, stream));
        case kF16: return static_cast<int>(launch_adam<__half>(p, g, m, v, pc, hyper, gscale, skip, n, adam_w_mode, stream));
        case kBF16: return static_cast<int>(launch_adam<__nv_bfloat16>(p, g, m, v, pc, hyper, gscale, skip, n, adam_w_mode, stream));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
