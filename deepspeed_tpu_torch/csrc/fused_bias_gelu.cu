// fused_bias_gelu: dropout(gelu_tanh(x + b)) forward and its backward.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/fused_bias_gelu.py
// _fwd_kernel (line 70) and _bwd_kernel (line 80).  x is [rows, C] in any
// of fp32/fp16/bf16, b is [C]; the math is fp32 in the Pallas kernels'
// order, rounded once to x's dtype:
//   forward   y = gelu(x + b), then y = y * keep * (1 / (1 - rate));
//   backward  g' = g * keep * (1 / (1 - rate)), dx = g' * gelu'(x + b),
//             and the bias gradient as fp32 column sums of dx, one row of
//             partials per 256 rows (db_part [ceil(rows / 256), C]),
//             summed outside in a fixed order: no atomics, so repeated
//             runs are bitwise equal.
// keep is the Pallas kernels' counter-hash mask (_keep_mask, line 48):
// the counter is the element's global index row * C + col in uint32 with
// wrap-around, mixed with seed * 0x9E3779B9 through the murmur3
// finalizer, and keep = ((h >> 8) * 2^-24 >= rate).  It depends on
// nothing but (seed, row, col), so the mask is bitwise that of the plain
// version and of the JAX kernel whatever the launch shape, and the
// backward regenerates it instead of reading it.  The TPU's C % 128 gate
// does not carry over: every C runs.
//
// Bound on the H100: memory.  The forward reads x and writes y (4 bytes
// per bf16 element), the backward reads x and g and writes dx (6 bytes)
// plus 4 bytes per column per 256 rows of partials, against some 30
// FLOPs and one tanh per element.  What the design does about it: the
// forward walks the flat array in 16-byte vectors (the column is the flat
// index mod C); the backward gives each thread 16 bytes of columns of a
// 256-row block and a strided eighth of its rows, so neighbouring threads
// read neighbouring vectors, and the eight row partials of a column meet
// in shared memory in a fixed order.
#include "common.cuh"

#define DS_BG_THREADS 256
#define DS_BG_UNROLL 4
#define DS_BG_BLOCK_ROWS 256   // rows per bias-gradient partial (_BLOCK_ROWS)
#define DS_BG_TY 8             // row groups of a backward block
#define DS_BG_TX 32            // column threads of a backward block

// the Python constants of fused_bias_gelu.py, rounded to fp32 as JAX does
// when they meet an fp32 array
#define DS_SQRT_2_OVER_PI 0.7978845608028654f
#define DS_GELU_C 0.044715f
#define DS_GELU_3C static_cast<float>(3.0 * 0.044715)

__device__ __forceinline__ float gelu_tanh(float x) {
    const float inner = DS_SQRT_2_OVER_PI * (x + DS_GELU_C * x * x * x);
    return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
    const float x3 = DS_GELU_C * x * x * x;
    const float t = tanhf(DS_SQRT_2_OVER_PI * (x + x3));
    const float sech2 = 1.0f - t * t;
    return 0.5f * (1.0f + t) + 0.5f * x * sech2 * DS_SQRT_2_OVER_PI * (1.0f + DS_GELU_3C * x * x);
}

// 1.0 where the element of global index gid is kept, else 0.0
__device__ __forceinline__ float keep_mask(uint32_t gid, uint32_t seed, float rate) {
    uint32_t h = gid ^ (seed * 0x9E3779B9u);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    const float u = static_cast<float>(h >> 8) * 5.9604644775390625e-08f;
    return u >= rate ? 1.0f : 0.0f;
}

struct BGArgs {
    uint32_t seed;
    float rate;     // <= 0: no dropout
    float scale;    // 1 / (1 - rate), rounded to fp32
};

__device__ __forceinline__ float bg_forward(float x, float b, unsigned long long gid,
                                            const BGArgs& a) {
    float y = gelu_tanh(x + b);
    if (a.rate > 0.0f) y = y * keep_mask(static_cast<uint32_t>(gid), a.seed, a.rate) * a.scale;
    return y;
}

template <typename T, typename TB, int VEC>
__global__ void __launch_bounds__(DS_BG_THREADS)
bias_gelu_fwd_kernel(const T* __restrict__ x, const TB* __restrict__ b, T* __restrict__ y,
                     long long n, int C, BGArgs a) {
    struct alignas(VEC * sizeof(T)) Pack { T v[VEC]; };
    const long long nvec = n / VEC;
    const long long tile = (long long)blockIdx.x * DS_BG_THREADS * DS_BG_UNROLL;
    const int c_tile = static_cast<int>((tile * VEC) % C);
    Pack xs[DS_BG_UNROLL];
#pragma unroll
    for (int u = 0; u < DS_BG_UNROLL; ++u) {
        const long long i = tile + u * DS_BG_THREADS + threadIdx.x;
        if (i < nvec) xs[u] = reinterpret_cast<const Pack*>(x)[i];
    }
#pragma unroll
    for (int u = 0; u < DS_BG_UNROLL; ++u) {
        const int j = u * DS_BG_THREADS + threadIdx.x;
        const long long i = tile + j;
        if (i >= nvec) continue;
        int c = static_cast<int>((c_tile + static_cast<long long>(j) * VEC) % C);
        Pack o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            o.v[k] = from_float<T>(bg_forward(to_float(xs[u].v[k]), to_float(__ldg(b + c)),
                                              static_cast<unsigned long long>(i) * VEC + k, a));
            c = c + 1 == C ? 0 : c + 1;
        }
        reinterpret_cast<Pack*>(y)[i] = o;
    }
    if (blockIdx.x == 0 && threadIdx.x < n - nvec * VEC) {
        const long long e = nvec * VEC + threadIdx.x;
        y[e] = from_float<T>(bg_forward(to_float(x[e]), to_float(__ldg(b + e % C)),
                                        static_cast<unsigned long long>(e), a));
    }
}

// grid (ceil(C / (DS_BG_TX * VEC)), ceil(rows / DS_BG_BLOCK_ROWS)), block
// (DS_BG_TX, DS_BG_TY): thread (tx, ty) owns columns col0 .. col0+VEC-1
// and rows r0 + ty, r0 + ty + DS_BG_TY, ... of the block's 256 rows.
template <typename T, typename TB, int VEC>
__global__ void __launch_bounds__(DS_BG_TX * DS_BG_TY)
bias_gelu_bwd_kernel(const T* __restrict__ x, const TB* __restrict__ b, const T* __restrict__ g,
                     T* __restrict__ dx, float* __restrict__ db_part, long long rows, int C,
                     BGArgs a) {
    struct alignas(VEC * sizeof(T)) Pack { T v[VEC]; };
    __shared__ float part[DS_BG_TY][DS_BG_TX * VEC];
    const int col0 = (blockIdx.x * DS_BG_TX + threadIdx.x) * VEC;
    const long long r0 = (long long)blockIdx.y * DS_BG_BLOCK_ROWS;
    const long long r_end = r0 + DS_BG_BLOCK_ROWS < rows ? r0 + DS_BG_BLOCK_ROWS : rows;
    const bool live = col0 < C;   // C % VEC == 0, so a live vector is whole
    float bias[VEC], sum[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        bias[k] = live ? to_float(__ldg(b + col0 + k)) : 0.f;
        sum[k] = 0.f;
    }
    if (live) {
        for (long long r = r0 + threadIdx.y; r < r_end; r += DS_BG_TY) {
            const long long off = r * C + col0;
            const Pack xv = *reinterpret_cast<const Pack*>(x + off);
            const Pack gv = *reinterpret_cast<const Pack*>(g + off);
            Pack o;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                const float v = to_float(xv.v[k]) + bias[k];
                float gg = to_float(gv.v[k]);
                if (a.rate > 0.0f)
                    gg = gg * keep_mask(static_cast<uint32_t>(off + k), a.seed, a.rate) * a.scale;
                const float d = gg * gelu_tanh_grad(v);
                o.v[k] = from_float<T>(d);
                sum[k] += d;
            }
            *reinterpret_cast<Pack*>(dx + off) = o;
        }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[threadIdx.y][threadIdx.x * VEC + k] = sum[k];
    __syncthreads();
    // the eight row partials of each column, summed in row-group order
    for (int cc = threadIdx.y * DS_BG_TX + threadIdx.x; cc < DS_BG_TX * VEC;
         cc += DS_BG_TX * DS_BG_TY) {
        const int col = blockIdx.x * DS_BG_TX * VEC + cc;
        if (col >= C) continue;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < DS_BG_TY; ++t) s += part[t][cc];
        db_part[(long long)blockIdx.y * C + col] = s;
    }
}

template <typename T, typename TB>
static cudaError_t launch_fwd(const void* x, const void* b, void* y, long long n, int C,
                              const BGArgs& a, cudaStream_t stream) {
    constexpr int V = VecWidth<T>::value;
    const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
    const long long per_block = (long long)DS_BG_THREADS * DS_BG_UNROLL;
    const long long blocks = (vec ? n / V : n) / per_block + 1;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const TB* bt = static_cast<const TB*>(b);
    T* yt = static_cast<T*>(y);
    if (vec)
        bias_gelu_fwd_kernel<T, TB, V><<<static_cast<unsigned>(blocks), DS_BG_THREADS, 0, stream>>>(
            xt, bt, yt, n, C, a);
    else
        bias_gelu_fwd_kernel<T, TB, 1><<<static_cast<unsigned>(blocks), DS_BG_THREADS, 0, stream>>>(
            xt, bt, yt, n, C, a);
    return cudaGetLastError();
}

template <typename T, typename TB>
static cudaError_t launch_bwd(const void* x, const void* b, const void* g, void* dx, float* db_part,
                              long long rows, int C, const BGArgs& a, cudaStream_t stream) {
    constexpr int V = VecWidth<T>::value;
    const bool vec = C % V == 0 &&
                     (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
    const int vw = vec ? V : 1;
    const long long gy = (rows + DS_BG_BLOCK_ROWS - 1) / DS_BG_BLOCK_ROWS;
    if (gy > 65535) return cudaErrorInvalidValue;
    const dim3 grid((C + DS_BG_TX * vw - 1) / (DS_BG_TX * vw), static_cast<unsigned>(gy));
    const dim3 block(DS_BG_TX, DS_BG_TY);
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(g);
    const TB* bt = static_cast<const TB*>(b);
    T* dxt = static_cast<T*>(dx);
    if (vec)
        bias_gelu_bwd_kernel<T, TB, V><<<grid, block, 0, stream>>>(xt, bt, gt, dxt, db_part, rows, C, a);
    else
        bias_gelu_bwd_kernel<T, TB, 1><<<grid, block, 0, stream>>>(xt, bt, gt, dxt, db_part, rows, C, a);
    return cudaGetLastError();
}

#define DS_BG_DISPATCH(x_dtype, b_dtype, CALL)                                     \
    switch (x_dtype * 3 + b_dtype) {                                               \
        case kF32 * 3 + kF32: return static_cast<int>(CALL(float, float));         \
        case kF32 * 3 + kF16: return static_cast<int>(CALL(float, __half));        \
        case kF32 * 3 + kBF16: return static_cast<int>(CALL(float, __nv_bfloat16));\
        case kF16 * 3 + kF32: return static_cast<int>(CALL(__half, float));        \
        case kF16 * 3 + kF16: return static_cast<int>(CALL(__half, __half));       \
        case kF16 * 3 + kBF16: return static_cast<int>(CALL(__half, __nv_bfloat16));\
        case kBF16 * 3 + kF32: return static_cast<int>(CALL(__nv_bfloat16, float)); \
        case kBF16 * 3 + kF16: return static_cast<int>(CALL(__nv_bfloat16, __half));\
        case kBF16 * 3 + kBF16: return static_cast<int>(CALL(__nv_bfloat16, __nv_bfloat16)); \
        default: return static_cast<int>(cudaErrorInvalidValue);                  \
    }

// x, y: rows * C contiguous elements of x_dtype; b: C of b_dtype.
extern "C" int bias_gelu_fwd(const void* x, const void* b, void* y, int x_dtype, int b_dtype,
                             long long rows, int C, unsigned int seed, float rate, float scale,
                             void* stream_ptr) {
    if (rows == 0) return 0;
    if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const BGArgs a{seed, rate, scale};
    const long long n = rows * C;
#define DS_BG_FWD(T, TB) launch_fwd<T, TB>(x, b, y, n, C, a, stream)
    DS_BG_DISPATCH(x_dtype, b_dtype, DS_BG_FWD)
#undef DS_BG_FWD
}

// x, g, dx: rows * C contiguous elements of x_dtype; b: C of b_dtype;
// db_part: ceil(rows / 256) * C fp32, every element written.
extern "C" int bias_gelu_bwd(const void* x, const void* b, const void* g, void* dx,
                             float* db_part, int x_dtype, int b_dtype, long long rows, int C,
                             unsigned int seed, float rate, float scale, void* stream_ptr) {
    if (rows == 0) return 0;
    if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const BGArgs a{seed, rate, scale};
#define DS_BG_BWD(T, TB) launch_bwd<T, TB>(x, b, g, dx, db_part, rows, C, a, stream)
    DS_BG_DISPATCH(x_dtype, b_dtype, DS_BG_BWD)
#undef DS_BG_BWD
}
