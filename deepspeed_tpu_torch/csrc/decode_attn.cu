// decode_attn: one query token per (b, h) over the padded KV cache.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// _decode_kernel (line 101): row b's query sees cache slots 0..pos[b]
// (pos scalar or per row); fp32 math with q scaled first, K and V widened
// to fp32, running max floored at M_FLOOR.  decode_attn_int8 is the
// kernel's int8-cache option (:135-137): K and V arrive as int8 codes with
// one fp32 scale per head vector ([B, S_max, H, 1], read through its own
// strides) and are dequantized in registers as code * scale, in fp32 and
// in the JAX kernel's order, before q.k and p.v.  The window and ALiBi
// options are not ported yet; the wrapper refuses them.
//
// Bound on the H100: memory.  Each live cache row is read once (2*D
// elements of K and V, plus two fp32 scales for the int8 cache) for 4*D
// FLOPs, so the least time is the live-prefix K/V bytes over 3.35 TB/s;
// the int8 cache moves 0.53x the bf16 bytes at D = 64.  What the design
// does about it: one CTA of 256 threads per (b, h) streams rows 0..pos[b]
// only and never touches slots past the row's frontier; a key row is read
// by D/VEC neighbouring lanes with one 16-byte load each (VEC = 8 bf16 or
// 16 int8 codes), so a warp reads whole cache lines; each group of lanes
// keeps UNROLL key rows of K and V in flight before it uses them; every
// group runs its own online softmax over the keys j = g, g + G, ... and
// the G partial states are merged once through shared memory at the end.
// The cache is read in place through its strides (no transpose copy).
#include "common.cuh"

#define DS_DECODE_THREADS 256
#define DS_DECODE_UNROLL 4

struct DecodeArgs {
    const void* q; const void* k; const void* v; void* o;
    int H;
    long long q_sb, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_sh;
    const int* pos;
    int pos_scalar;
    float scale;
    // int8 cache only: per-vector scales [B, S_max, H, 1]
    const float* k_scale; const float* v_scale;
    long long ks_sb, ks_ss, ks_sh;
    long long vs_sb, vs_ss, vs_sh;
};

// T: the query and output type; C: the cache type (T, or int8_t codes)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(DS_DECODE_THREADS)
decode_attn_kernel(const DecodeArgs a) {
    constexpr bool Q8 = std::is_same<C, int8_t>::value;
    constexpr int VEC = VecWidth<C>::value;              // cache elements per load
    constexpr int TPK = D / VEC;                         // lanes per key row
    constexpr int G = DS_DECODE_THREADS / TPK;           // key groups
    constexpr int U = DS_DECODE_UNROLL;
    __shared__ float m_s[G];
    __shared__ float l_s[G];
    __shared__ float acc_s[G][D];

    const int tid = threadIdx.x;
    const int g = tid / TPK;
    const int lane = tid % TPK;
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int npos = (a.pos ? a.pos[b] : a.pos_scalar) + 1;  // visible keys

    float qf[VEC];
    load_widen<T, VEC>(static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + lane * VEC, qf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[e] *= a.scale;
    const C* kp = static_cast<const C*>(a.k) + b * a.k_sb + h * a.k_sh + lane * VEC;
    const C* vp = static_cast<const C*>(a.v) + b * a.v_sb + h * a.v_sh + lane * VEC;
    const float* ksp = Q8 ? a.k_scale + b * a.ks_sb + h * a.ks_sh : nullptr;
    const float* vsp = Q8 ? a.v_scale + b * a.vs_sb + h * a.vs_sh : nullptr;

    float m = DS_M_FLOOR, l = 0.f;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

    // the trip count is the same for every thread (base steps over the
    // whole CTA's keys): the key-row shuffles below name all 32 lanes, so
    // no group may leave the loop while a neighbour in its warp stays
    for (int base = 0; base < npos; base += G * U) {
        const int j0 = base + g;
        uint4 kr[U], vr[U];
        float ksc[U], vsc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u * G;
            if (j < npos) {
                kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + (long long)j * a.k_ss));
                vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + (long long)j * a.v_ss));
                if constexpr (Q8) {
                    ksc[u] = __ldg(ksp + (long long)j * a.ks_ss);
                    vsc[u] = __ldg(vsp + (long long)j * a.vs_ss);
                }
            } else {
                kr[u] = make_uint4(0u, 0u, 0u, 0u);
                vr[u] = make_uint4(0u, 0u, 0u, 0u);
                if constexpr (Q8) { ksc[u] = 0.f; vsc[u] = 0.f; }
            }
        }
        float s[U];
        float smax = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float kf[VEC];
            widen16(kr[u], kf, C());
            if constexpr (Q8) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) kf[e] *= ksc[u];
            }
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) part += qf[e] * kf[e];
            // the TPK lanes of a key row are neighbours in one warp
#pragma unroll
            for (int o = TPK / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
            s[u] = (j0 + u * G < npos) ? part : -INFINITY;
            smax = fmaxf(smax, s[u]);
        }
        const float m_new = fmaxf(m, smax);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const float p = expf(s[u] - m_new);
            float vf[VEC];
            widen16(vr[u], vf, C());
            if constexpr (Q8) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) vf[e] *= vsc[u];
            }
            l += p;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += p * vf[e];
        }
        m = m_new;
    }

    // merge the G groups' (m, l, acc) states
    if (lane == 0) { m_s[g] = m; l_s[g] = l; }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_s[g][lane * VEC + e] = acc[e];
    __syncthreads();
    if (tid >= D) return;
    float mt = DS_M_FLOOR;
    for (int i = 0; i < G; ++i) mt = fmaxf(mt, m_s[i]);
    float lt = 0.f, at = 0.f;
    for (int i = 0; i < G; ++i) {
        const float w = expf(m_s[i] - mt);
        lt += l_s[i] * w;
        at += acc_s[i][tid] * w;
    }
    T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
    op[tid] = from_float<T>(at / lt);
}

template <typename T, typename C, int D>
static cudaError_t launch_decode(int B, const DecodeArgs& a, cudaStream_t stream) {
    const dim3 grid(a.H, B);
    decode_attn_kernel<T, C, D><<<grid, DS_DECODE_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

// Q8 = false: the cache has the query's type; true: int8 codes
template <bool Q8>
static int dispatch_decode(int dtype, int B, int D, const DecodeArgs& a, cudaStream_t s) {
#define DS_DECODE_D(T)                                                                  \
    {                                                                                   \
        using C = typename std::conditional<Q8, int8_t, T>::type;                       \
        switch (D) {                                                                    \
            case 32: return static_cast<int>(launch_decode<T, C, 32>(B, a, s));          \
            case 64: return static_cast<int>(launch_decode<T, C, 64>(B, a, s));          \
            case 128: return static_cast<int>(launch_decode<T, C, 128>(B, a, s));        \
            default: return static_cast<int>(cudaErrorInvalidValue);                    \
        }                                                                               \
    }
    switch (dtype) {
        case kF32: DS_DECODE_D(float)
        case kF16: DS_DECODE_D(__half)
        case kBF16: DS_DECODE_D(__nv_bfloat16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DS_DECODE_D
}

extern "C" int decode_attn(const void* q, const void* k, const void* v, void* o,
                           int dtype, int B, int H, int D,
                           long long q_sb, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_sh,
                           const int* pos, int pos_scalar, float scale, void* stream) {
    if (B == 0 || H == 0) return 0;
    const DecodeArgs a{q, k, v, o, H, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                       o_sb, o_sh, pos, pos_scalar, scale};
    return dispatch_decode<false>(dtype, B, D, a, static_cast<cudaStream_t>(stream));
}

// k, v: int8 codes; k_scale, v_scale: fp32 [B, S_max, H, 1] through strides
extern "C" int decode_attn_int8(const void* q, const void* k, const void* v, void* o,
                                int dtype, int B, int H, int D,
                                long long q_sb, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_sh,
                                const float* k_scale, const float* v_scale,
                                long long ks_sb, long long ks_ss, long long ks_sh,
                                long long vs_sb, long long vs_ss, long long vs_sh,
                                const int* pos, int pos_scalar, float scale, void* stream) {
    if (B == 0 || H == 0) return 0;
    const DecodeArgs a{q, k, v, o, H, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                       o_sb, o_sh, pos, pos_scalar, scale, k_scale, v_scale,
                       ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
    return dispatch_decode<true>(dtype, B, D, a, static_cast<cudaStream_t>(stream));
}
