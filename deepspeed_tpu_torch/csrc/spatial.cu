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
// about it: neighbouring threads load neighbouring 16-byte vectors, and
// the launch is sized to the tensor and the card.  A large tensor gives
// each thread DS_SPATIAL_UNROLL vectors, all loaded before any is summed,
// in CTAs of 256 threads; a tensor too small to fill every SM that way
// (SD-1.5's 8x8 and 64x64 maps) gives each thread one vector, in CTAs
// sized so that the grid has at least one CTA per SM (the SM count is
// read once from the device).  The bias (C values, a few KB) is read
// through the read-only cache, where it stays: where C is a multiple of
// the vector width and the biases are aligned, a vector's biases are one
// 16-byte load (two for fp32 biases of a bf16 x), else one scalar load
// per element with a wrap at C.  Channels are 32-bit remainders.
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

// the word of a read-only load of 16 or 8 bytes
template <int BYTES> struct LdgWord;
template <> struct LdgWord<16> { using type = uint4; };
template <> struct LdgWord<8> { using type = uint2; };

// N consecutive biases b[c .. c + N) as fp32, in 16-byte read-only loads
// (one 8-byte load for four 16-bit biases); b + c aligned to
// min(16, N * sizeof(TB))
template <typename TB, int N>
__device__ __forceinline__ void bias_vec(const TB* __restrict__ b, int c, float (&out)[N]) {
    constexpr int BYTES = N * sizeof(TB);
    constexpr int CHUNK = BYTES < 16 ? BYTES : 16;
    constexpr int PER = CHUNK / sizeof(TB);
    using W = typename LdgWord<CHUNK>::type;
#pragma unroll
    for (int i = 0; i < N / PER; ++i) {
        const W w = __ldg(reinterpret_cast<const W*>(b + c) + i);
        const TB* v = reinterpret_cast<const TB*>(&w);
#pragma unroll
        for (int k = 0; k < PER; ++k) out[i * PER + k] = to_float(v[k]);
    }
}

// VEC elements of T per access (VEC = 16 / sizeof(T) on the vector path,
// 1 on the scalar path); BVEC: the biases of an access are one aligned
// vector (C % VEC == 0); block `blockIdx.x` owns blockDim.x * UNROLL
// consecutive accesses of the flat array.
template <typename T, typename TB, int VARIANT, int VEC, int UNROLL, bool BVEC>
__global__ void __launch_bounds__(DS_SPATIAL_THREADS)
spatial_kernel(const T* __restrict__ x, const TB* __restrict__ b, const T* __restrict__ y,
               const TB* __restrict__ b2, T* __restrict__ out, long long n, int C) {
    struct alignas(VEC * sizeof(T)) Pack { T v[VEC]; };
    const long long nvec = n / VEC;
    const int threads = blockDim.x;
    const long long tile = (long long)blockIdx.x * threads * UNROLL;
    // channel of the tile's first element (a 32-bit remainder whenever
    // the flat index fits in 32 bits); offsets inside the tile are small,
    // so the per-access channel is a 32-bit remainder too
    const long long first = tile * VEC;
    const int c_tile = first < (1ll << 31) ? static_cast<int>(first) % C : static_cast<int>(first % C);
    Pack xs[UNROLL], ys[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = tile + u * threads + threadIdx.x;
        if (i < nvec) {
            xs[u] = reinterpret_cast<const Pack*>(x)[i];
            if constexpr (VARIANT >= 1) ys[u] = reinterpret_cast<const Pack*>(y)[i];
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const int j = u * threads + threadIdx.x;
        if (tile + j >= nvec) continue;
        int c = (c_tile + j * VEC) % C;
        Pack o;
        if constexpr (BVEC) {
            // c is a multiple of VEC: the access's channels are c .. c + VEC - 1
            float bv[VEC], b2v[VEC];
            bias_vec<TB, VEC>(b, c, bv);
            if constexpr (VARIANT >= 2) bias_vec<TB, VEC>(b2, c, b2v);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                const float yv = VARIANT >= 1 ? to_float(ys[u].v[k]) : 0.f;
                o.v[k] = from_float<T>(spatial_sum<VARIANT>(to_float(xs[u].v[k]), bv[k], yv,
                                                             VARIANT >= 2 ? b2v[k] : 0.f));
            }
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                const float yv = VARIANT >= 1 ? to_float(ys[u].v[k]) : 0.f;
                const float b2v = VARIANT >= 2 ? bias_at(b2, c) : 0.f;
                o.v[k] = from_float<T>(spatial_sum<VARIANT>(to_float(xs[u].v[k]), bias_at(b, c),
                                                             yv, b2v));
                c = c + 1 == C ? 0 : c + 1;
            }
        }
        reinterpret_cast<Pack*>(out)[tile + j] = o;
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

template <typename T, typename TB, int VARIANT, int VEC, bool BVEC>
static cudaError_t launch_sized(const T* x, const TB* b, const T* y, const TB* b2, T* out, long long n, int C,
                                long long nvec, cudaStream_t stream) {
    const long long sms = sm_count();
    const long long per_block = (long long)DS_SPATIAL_THREADS * DS_SPATIAL_UNROLL;
    if (nvec >= per_block * sms) {
        const long long blocks = (nvec + per_block - 1) / per_block;
        if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
        spatial_kernel<T, TB, VARIANT, VEC, DS_SPATIAL_UNROLL, BVEC>
            <<<static_cast<unsigned>(blocks), DS_SPATIAL_THREADS, 0, stream>>>(x, b, y, b2, out, n, C);
    } else {
        // one access per thread, at least one CTA per SM where there are
        // 32 accesses per SM to give; block 0 also runs the tail
        long long threads = (nvec + sms - 1) / sms;
        threads = threads < 32 ? 32 : threads > DS_SPATIAL_THREADS ? DS_SPATIAL_THREADS : (threads + 31) / 32 * 32;
        const long long blocks = nvec > 0 ? (nvec + threads - 1) / threads : 1;
        spatial_kernel<T, TB, VARIANT, VEC, 1, BVEC>
            <<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads), 0, stream>>>(x, b, y, b2, out, n, C);
    }
    return cudaGetLastError();
}

template <typename T, typename TB, int VARIANT>
static cudaError_t launch_spatial(const void* x, const void* b, const void* y, const void* b2,
                                  void* out, long long n, int C, cudaStream_t stream) {
    constexpr int V = VecWidth<T>::value;
    constexpr int BALIGN = V * sizeof(TB) < 16 ? V * sizeof(TB) : 16;
    const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                      (VARIANT >= 1 ? reinterpret_cast<uintptr_t>(y) : 0)) % 16 == 0;
    const bool bvec = vec && C % V == 0 &&
                      (reinterpret_cast<uintptr_t>(b) | (VARIANT >= 2 ? reinterpret_cast<uintptr_t>(b2) : 0)) %
                              BALIGN == 0;
    const T* xt = static_cast<const T*>(x);
    const T* yt = static_cast<const T*>(y);
    const TB* bt = static_cast<const TB*>(b);
    const TB* b2t = static_cast<const TB*>(b2);
    T* ot = static_cast<T*>(out);
    if (bvec) return launch_sized<T, TB, VARIANT, V, true>(xt, bt, yt, b2t, ot, n, C, n / V, stream);
    if (vec) return launch_sized<T, TB, VARIANT, V, false>(xt, bt, yt, b2t, ot, n, C, n / V, stream);
    return launch_sized<T, TB, VARIANT, 1, false>(xt, bt, yt, b2t, ot, n, C, n, stream);
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
