// Shared helpers of the port's attention kernels: dtype codes, 16-byte
// vector loads that widen to fp32 (int8 cache codes too), narrowing stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// dtype codes of the C interface (ops/kernels/utils.py DTYPE_CODES)
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

// running-max floor of the decode and chunk kernels
// (decode_attention.py M_FLOOR): keeps exp(m_prev - m_new) finite
#define DS_M_FLOOR (-1e30f)

// elements of T in one 16-byte vector
template <typename T> struct VecWidth { static constexpr int value = 16 / sizeof(T); };

// The head dim of the tile an attention kernel computes head dim D in
// (ops/kernels/utils.py tile_dim): D itself at 32, 64 and 128; D 80 and 96
// (GPT-2 2.7B, 760M) in the tile of 128.  A tensor-core tile's second
// 64-column box then runs past D: TMA zero-fills its columns past D
// (dims[0] = D) and still counts the whole box's bytes; products whose
// depth is D stop at D's last 16-column step, those whose N is D compute
// the padded columns and never store them.  An FMA kernel's row of D
// floats is padded with zeros to the tile, so its lanes stay a power of
// two a row.
__host__ __device__ constexpr int tile_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

// every D the attention kernels take lies in a tile of a whole number of
// 16-column steps (the k16 depth of wgmma and mma.sync)
template <int D>
struct HeadDim {
    static_assert(D == 32 || D == 64 || D == 80 || D == 96 || D == 128, "head dims of these kernels");
    static_assert(D % 16 == 0 && D <= tile_dim(D), "a head dim of whole 16-column steps");
    static constexpr int TILE = tile_dim(D);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the TPU kernels cast p to the input
// dtype before the P.V product
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_float(from_float<T>(x));
}

// 16 bytes (VecWidth<T> elements) as fp32
__device__ __forceinline__ void widen16(const uint4& r, float* out, float) {
    out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen16(const uint4& r, float* out, __half) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float2 f = __half22float2(h[i]);
        out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
}
__device__ __forceinline__ void widen16(const uint4& r, float* out, __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
}

// 16 int8 codes as fp32 (exact); the caller multiplies by the row's scale
__device__ __forceinline__ void widen16(const uint4& r, float* out, int8_t) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
}

// N consecutive elements of T (16-byte aligned, N a multiple of
// VecWidth<T>) as fp32, one 16-byte load per VecWidth<T> elements
template <typename T, int N>
__device__ __forceinline__ void load_widen(const T* p, float* out) {
    constexpr int V = VecWidth<T>::value;
#pragma unroll
    for (int i = 0; i < N / V; ++i)
        widen16(*reinterpret_cast<const uint4*>(p + i * V), out + i * V, T());
}

// four consecutive elements of T (8 or 16 bytes, aligned) as fp32
template <typename T> __device__ __forceinline__ float4 load4(const T* p) {
    float4 f;
    f.x = to_float(p[0]); f.y = to_float(p[1]);
    f.z = to_float(p[2]); f.w = to_float(p[3]);
    return f;
}
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

template <typename T> __device__ __forceinline__ void store4(T* p, float a, float b, float c, float d) {
    p[0] = from_float<T>(a); p[1] = from_float<T>(b);
    p[2] = from_float<T>(c); p[3] = from_float<T>(d);
}
template <> __device__ __forceinline__ void store4<float>(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// four consecutive elements of T as one 16- or 8-byte store
template <typename T> __device__ __forceinline__ void store_vec4(T* dst, const float4& f);
template <> __device__ __forceinline__ void store_vec4<float>(float* dst, const float4& f) {
    *reinterpret_cast<float4*>(dst) = f;
}
template <> __device__ __forceinline__ void store_vec4<__nv_bfloat16>(__nv_bfloat16* dst, const float4& f) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y), hi = __floats2bfloat162_rn(f.z, f.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
}
template <> __device__ __forceinline__ void store_vec4<__half>(__half* dst, const float4& f) {
    __half2 lo = __floats2half2_rn(f.x, f.y), hi = __floats2half2_rn(f.z, f.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
}

// the card's SM count, read once (host side)
static int sm_count() {
    static const int count = [] {
        int dev = 0, n = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            return 1;
        return n;
    }();
    return count;
}

extern "C" const char* ds_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
