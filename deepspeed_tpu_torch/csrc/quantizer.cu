// quantizer: grouped quantization to int8 codes with one fp32 scale (and
// offset) per group.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/quantizer.py
// _quant_kernel (line 89): each row of gsize elements ("group") is read in
// its own dtype and widened to fp32 in registers; symmetric mode takes
// scale = max(absmax / qmax, 1e-12) and offset 0, asymmetric mode
// scale = max((hi - lo) / (2 qmax), 1e-12) and offset (hi + lo) / 2; the
// codes are clip(rint((x - offset) / scale), -qmax, qmax) with
// qmax = 2^(bits-1) - 1.  rintf rounds half to even like jnp.round, and the
// division is IEEE (no --use_fast_math; x * (1/scale) would move codes at
// the .5 boundaries), so the deterministic codes, scales and offsets are
// bitwise those of the plain version.  Stochastic rounding adds noise in
// [-0.5, 0.5) from a counter hash over (seed, logical element index): the
// result does not depend on the launch shape, and the plain version draws
// the same noise.  The TPU's per-block PRNG stream is not reproduced.
//
// The TPU gates (groups % 8, the 4 MiB single block, gsize < 128 → jnp)
// do not carry over: every group size runs here.  Rows are addressed
// through up to three leading dims with their own strides, so a K or V
// head vector is quantized straight from the strided qkv projection.
//
// Bound on the H100: memory.  Each element is read once and its code
// written once (3 bytes per bf16 element) plus 4 or 8 bytes per group, for
// a handful of FLOPs: the least time is those bytes over 3.35 TB/s.  What
// the design does about it: a team of threads owns a group (8 lanes for
// gsize <= 8, a warp up to 4,096, the whole CTA beyond), neighbouring
// lanes read neighbouring elements, the min/max is reduced with shuffles
// (and shared memory across the CTA's warps), and the second pass that
// writes the codes reads the group again from L1/L2, not from HBM.
#include "common.cuh"

#define DS_QUANT_THREADS 256

struct QuantArgs {
    const void* x;
    int8_t* q;            // [rows, gsize] contiguous codes
    float* scale;         // [rows]
    float* offset;        // [rows], or null: not written
    long long rows, gsize;
    long long n1, n2;     // rows = n0 * n1 * n2 (row-major)
    long long xs0, xs1, xs2;  // element strides of the three row dims
    float qmax;
    int symmetric;
    int stochastic;
    uint32_t seed_lo, seed_hi;
};

// Chris Wellons' lowbias32 integer hash (a bijection on 32 bits)
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7feb352du;
    x ^= x >> 15;
    x *= 0x846ca68bu;
    x ^= x >> 16;
    return x;
}

// noise in [-0.5, 0.5) for logical element idx: 24 hashed bits, so the
// conversion, the scaling by 2^-24 and the subtraction are all exact
__device__ __forceinline__ float sr_noise(unsigned long long idx, uint32_t s_lo, uint32_t s_hi) {
    const uint32_t u = lowbias32(lowbias32(static_cast<uint32_t>(idx) ^ s_lo) ^
                                 (static_cast<uint32_t>(idx >> 32) + s_hi));
    return static_cast<float>(u >> 8) * 5.9604644775390625e-08f - 0.5f;
}

// min and max over a team of TEAM lanes (TEAM <= 32: neighbours in one
// warp; TEAM > 32: the whole CTA).  Every lane of the CTA must arrive.
template <int TEAM>
__device__ __forceinline__ void team_minmax(float& lo, float& hi) {
    constexpr int W = TEAM < 32 ? TEAM : 32;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if constexpr (TEAM > 32) {
        __shared__ float lo_s[TEAM / 32], hi_s[TEAM / 32];
        const int w = threadIdx.x / 32;
        if (threadIdx.x % 32 == 0) { lo_s[w] = lo; hi_s[w] = hi; }
        __syncthreads();
        lo = lo_s[0];
        hi = hi_s[0];
#pragma unroll
        for (int i = 1; i < TEAM / 32; ++i) {
            lo = fminf(lo, lo_s[i]);
            hi = fmaxf(hi, hi_s[i]);
        }
    }
}

template <typename T, int TEAM>
__global__ void __launch_bounds__(DS_QUANT_THREADS)
quant_kernel(const QuantArgs a) {
    constexpr int PER_CTA = DS_QUANT_THREADS / TEAM;   // groups per CTA
    const int lane = threadIdx.x % TEAM;
    const long long r = static_cast<long long>(blockIdx.x) * PER_CTA + threadIdx.x / TEAM;
    const bool ok = r < a.rows;
    const T* xp = nullptr;
    if (ok) {
        const long long i2 = r % a.n2, i1 = (r / a.n2) % a.n1, i0 = r / (a.n2 * a.n1);
        xp = static_cast<const T*>(a.x) + i0 * a.xs0 + i1 * a.xs1 + i2 * a.xs2;
    }
    float lo = INFINITY, hi = -INFINITY;
    if (ok) {
        for (long long e = lane; e < a.gsize; e += TEAM) {
            const float v = to_float(xp[e]);
            if (a.symmetric) {
                hi = fmaxf(hi, fabsf(v));
            } else {
                lo = fminf(lo, v);
                hi = fmaxf(hi, v);
            }
        }
    }
    // every lane (rows past the end too) takes part in the reduction
    team_minmax<TEAM>(lo, hi);
    if (!ok) return;

    float scale, offset;
    if (a.symmetric) {
        scale = fmaxf(hi / a.qmax, 1e-12f);
        offset = 0.f;
    } else {
        scale = fmaxf((hi - lo) / (2.f * a.qmax), 1e-12f);
        offset = (hi + lo) / 2.f;
    }
    if (lane == 0) {
        a.scale[r] = scale;
        if (a.offset != nullptr) a.offset[r] = offset;
    }
    int8_t* qp = a.q + r * a.gsize;
    const unsigned long long base = static_cast<unsigned long long>(r) * a.gsize;
    for (long long e = lane; e < a.gsize; e += TEAM) {
        float s = (to_float(xp[e]) - offset) / scale;
        if (a.stochastic) s += sr_noise(base + e, a.seed_lo, a.seed_hi);
        s = fminf(fmaxf(rintf(s), -a.qmax), a.qmax);
        qp[e] = static_cast<int8_t>(__float2int_rn(s));
    }
}

template <typename T, int TEAM>
static cudaError_t launch_quant(const QuantArgs& a, cudaStream_t stream) {
    constexpr int PER_CTA = DS_QUANT_THREADS / TEAM;
    const long long blocks = (a.rows + PER_CTA - 1) / PER_CTA;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    quant_kernel<T, TEAM><<<static_cast<unsigned>(blocks), DS_QUANT_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_team(const QuantArgs& a, cudaStream_t stream) {
    if (a.gsize <= 8) return launch_quant<T, 8>(a, stream);
    if (a.gsize <= 4096) return launch_quant<T, 32>(a, stream);
    return launch_quant<T, DS_QUANT_THREADS>(a, stream);
}

// x: rows addressed as [n0, n1, n2] through strides (xs0, xs1, xs2), each
// row gsize contiguous elements of dtype; q: contiguous [rows, gsize].
extern "C" int quantizer(const void* x, void* q, float* scale, float* offset, int dtype,
                         long long n0, long long n1, long long n2, long long gsize,
                         long long xs0, long long xs1, long long xs2,
                         int bits, int symmetric, int stochastic,
                         unsigned long long seed, void* stream) {
    const long long rows = n0 * n1 * n2;
    if (rows == 0) return 0;
    if (gsize <= 0 || bits < 2 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
    const QuantArgs a{x, static_cast<int8_t*>(q), scale, offset, rows, gsize, n1, n2,
                      xs0, xs1, xs2, static_cast<float>((1 << (bits - 1)) - 1),
                      symmetric, stochastic, static_cast<uint32_t>(seed),
                      static_cast<uint32_t>(seed >> 32)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case kF32: return static_cast<int>(dispatch_team<float>(a, s));
        case kF16: return static_cast<int>(dispatch_team<__half>(a, s));
        case kBF16: return static_cast<int>(dispatch_team<__nv_bfloat16>(a, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
