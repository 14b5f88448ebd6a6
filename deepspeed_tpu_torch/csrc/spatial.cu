// spatial: the NHWC channel-bias add family of the diffusion models.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/spatial.py _kernel
// (line 28, x + b), _kernel_add (line 34, x + b + y) and _kernel_bias_bias
// (line 41, x + b + y + b2): x and y are [N, H, W, C] viewed as [N*H*W, C]
// rows, b and b2 are [C].  Each element is widened to fp32, summed left to
// right in that order, and rounded once to x's dtype, as the Pallas
// kernels do; in fp32 the result is bitwise that of the plain version.
//
// The TPU kernels need C % 128 == 0 (a Mosaic lane constraint); here every
// C runs, 3 and 4 included.  The [rows, C] tensor is walked as one flat
// array of 16-byte vectors when x, y and out are 16-byte aligned (a scalar
// walk otherwise), the n % vector elements past the last vector by a
// scalar tail; the channel of each element is its flat index mod C, so no
// row needs to start on a vector boundary.
//
// Bound on the H100: memory.  Each element of x (and y) is read once and
// each output written once, against one to three adds: in bf16 4 bytes
// per element for x + b, the bytes over 3.35 TB/s.  What the design does
// about it: neighbouring threads load neighbouring 16-byte vectors, each
// thread keeps DS_SPATIAL_UNROLL loads in flight, and the bias (C values,
// a few KB) is read through the read-only cache, where it stays.
#include "common.cuh"

#define DS_SPATIAL_THREADS 256
#define DS_SPATIAL_UNROLL 4

// one element: x + b (+ y (+ b2)) in fp32, left to right
template <int VARIANT>
__device__ __forceinline__ float spatial_sum(float x, float b, float y, float b2) {
    float s = x + b;
    if constexpr (VARIANT >= 1) s = s + y;
    if constexpr (VARIANT >= 2) s = s + b2;
    return s;
}

template <typename TB>
__device__ __forceinline__ float bias_at(const TB* __restrict__ b, int c) {
    return to_float(__ldg(b + c));
}

// VEC elements of T per access (VEC = 16 / sizeof(T) on the vector path,
// 1 on the scalar path).  Block `blockIdx.x` owns DS_SPATIAL_THREADS *
// DS_SPATIAL_UNROLL consecutive accesses of the flat array.
template <typename T, typename TB, int VARIANT, int VEC>
__global__ void __launch_bounds__(DS_SPATIAL_THREADS)
spatial_kernel(const T* __restrict__ x, const TB* __restrict__ b, const T* __restrict__ y,
               const TB* __restrict__ b2, T* __restrict__ out, long long n, int C) {
    struct alignas(VEC * sizeof(T)) Pack { T v[VEC]; };
    const long long nvec = n / VEC;
    const long long tile = (long long)blockIdx.x * DS_SPATIAL_THREADS * DS_SPATIAL_UNROLL;
    // channel of the tile's first element; offsets inside the tile are
    // small, so the per-access channel is a 32-bit remainder
    const int c_tile = static_cast<int>((tile * VEC) % C);
    Pack xs[DS_SPATIAL_UNROLL], ys[DS_SPATIAL_UNROLL];
#pragma unroll
    for (int u = 0; u < DS_SPATIAL_UNROLL; ++u) {
        const long long i = tile + u * DS_SPATIAL_THREADS + threadIdx.x;
        if (i < nvec) {
            xs[u] = reinterpret_cast<const Pack*>(x)[i];
            if constexpr (VARIANT >= 1) ys[u] = reinterpret_cast<const Pack*>(y)[i];
        }
    }
#pragma unroll
    for (int u = 0; u < DS_SPATIAL_UNROLL; ++u) {
        const int j = u * DS_SPATIAL_THREADS + threadIdx.x;
        const long long i = tile + j;
        if (i >= nvec) continue;
        int c = static_cast<int>((c_tile + static_cast<long long>(j) * VEC) % C);
        Pack o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const float yv = VARIANT >= 1 ? to_float(ys[u].v[k]) : 0.f;
            const float b2v = VARIANT >= 2 ? bias_at(b2, c) : 0.f;
            o.v[k] = from_float<T>(spatial_sum<VARIANT>(to_float(xs[u].v[k]), bias_at(b, c),
                                                         yv, b2v));
            c = c + 1 == C ? 0 : c + 1;
        }
        reinterpret_cast<Pack*>(out)[i] = o;
    }
    // the n % VEC elements past the last full access
    if (blockIdx.x == 0 && threadIdx.x < n - nvec * VEC) {
        const long long e = nvec * VEC + threadIdx.x;
        const int c = static_cast<int>(e % C);
        const float yv = VARIANT >= 1 ? to_float(y[e]) : 0.f;
        const float b2v = VARIANT >= 2 ? bias_at(b2, c) : 0.f;
        out[e] = from_float<T>(spatial_sum<VARIANT>(to_float(x[e]), bias_at(b, c), yv, b2v));
    }
}

template <typename T, typename TB, int VARIANT>
static cudaError_t launch_spatial(const void* x, const void* b, const void* y, const void* b2,
                                  void* out, long long n, int C, cudaStream_t stream) {
    constexpr int V = VecWidth<T>::value;
    const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                      (VARIANT >= 1 ? reinterpret_cast<uintptr_t>(y) : 0)) % 16 == 0;
    const long long per_block = (long long)DS_SPATIAL_THREADS * DS_SPATIAL_UNROLL;
    const long long nvec = vec ? n / V : n;
    const long long blocks = nvec / per_block + 1;  // +1: block 0 runs the tail even when nvec is 0
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* yt = static_cast<const T*>(y);
    const TB* bt = static_cast<const TB*>(b);
    const TB* b2t = static_cast<const TB*>(b2);
    T* ot = static_cast<T*>(out);
    if (vec)
        spatial_kernel<T, TB, VARIANT, V><<<static_cast<unsigned>(blocks), DS_SPATIAL_THREADS, 0,
                                            stream>>>(xt, bt, yt, b2t, ot, n, C);
    else
        spatial_kernel<T, TB, VARIANT, 1><<<static_cast<unsigned>(blocks), DS_SPATIAL_THREADS, 0,
                                            stream>>>(xt, bt, yt, b2t, ot, n, C);
    return cudaGetLastError();
}

template <typename T, typename TB>
static cudaError_t dispatch_variant(int variant, const void* x, const void* b, const void* y,
                                    const void* b2, void* out, long long n, int C,
                                    cudaStream_t stream) {
    switch (variant) {
        case 0: return launch_spatial<T, TB, 0>(x, b, y, b2, out, n, C, stream);
        case 1: return launch_spatial<T, TB, 1>(x, b, y, b2, out, n, C, stream);
        case 2: return launch_spatial<T, TB, 2>(x, b, y, b2, out, n, C, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
static cudaError_t dispatch_bias(int b_dtype, int variant, const void* x, const void* b,
                                 const void* y, const void* b2, void* out, long long n, int C,
                                 cudaStream_t stream) {
    switch (b_dtype) {
        case kF32: return dispatch_variant<T, float>(variant, x, b, y, b2, out, n, C, stream);
        case kF16: return dispatch_variant<T, __half>(variant, x, b, y, b2, out, n, C, stream);
        case kBF16: return dispatch_variant<T, __nv_bfloat16>(variant, x, b, y, b2, out, n, C, stream);
        default: return cudaErrorInvalidValue;
    }
}

// x, y, out: n = rows * C contiguous elements of x_dtype; b, b2: C
// contiguous elements of b_dtype.  variant 0: out = x + b; 1: out = x + b
// + y (y required); 2: out = x + b + y + b2 (y and b2 required).  y and b2
// may be null where the variant does not read them.
extern "C" int nhwc_bias_add(const void* x, const void* b, const void* y, const void* b2,
                             void* out, int x_dtype, int b_dtype, int variant, long long n,
                             int C, void* stream_ptr) {
    if (n == 0) return 0;
    if (C < 1 || n % C) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (x_dtype) {
        case kF32: return static_cast<int>(dispatch_bias<float>(b_dtype, variant, x, b, y, b2, out, n, C, stream));
        case kF16: return static_cast<int>(dispatch_bias<__half>(b_dtype, variant, x, b, y, b2, out, n, C, stream));
        case kBF16: return static_cast<int>(dispatch_bias<__nv_bfloat16>(b_dtype, variant, x, b, y, b2, out, n, C, stream));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
