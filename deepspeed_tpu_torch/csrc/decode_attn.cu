// decode_attn: one query token per (b, h) over the padded KV cache.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// _decode_kernel (line 101): row b's query sees cache slots 0..pos[b]
// (pos scalar or per row); fp32 math with q scaled first, K and V widened
// to fp32, running max floored at M_FLOOR.  The window, ALiBi and
// int8-cache options are not ported yet; the wrapper refuses them.
//
// Bound on the H100: memory.  Each live cache row is read once (2*D
// elements of K and V) for 4*D FLOPs, so the least time is the live-prefix
// K/V bytes over 3.35 TB/s.  What the design does about it: one CTA of 256
// threads per (b, h) streams rows 0..pos[b] only and never touches slots
// past the row's frontier; a key row is read by D/VEC neighbouring lanes
// with one 16-byte load each, so a warp reads whole cache lines; each
// group of lanes keeps UNROLL key rows of K and V in flight before it
// uses them; every group runs its own online softmax over the keys
// j = g, g + G, ... and the G partial states are merged once through
// shared memory at the end.  The cache is read in place through its
// strides (no transpose copy).
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
};

template <typename T, int D>
__global__ void __launch_bounds__(DS_DECODE_THREADS)
decode_attn_kernel(const DecodeArgs a) {
    constexpr int VEC = VecWidth<T>::value;
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
    {
        const uint4 qr = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + lane * VEC);
        widen16(qr, qf, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[e] *= a.scale;
    }
    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + lane * VEC;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + lane * VEC;

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
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u * G;
            if (j < npos) {
                kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + (long long)j * a.k_ss));
                vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + (long long)j * a.v_ss));
            } else {
                kr[u] = make_uint4(0u, 0u, 0u, 0u);
                vr[u] = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        float s[U];
        float smax = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float kf[VEC];
            widen16(kr[u], kf, T());
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
            widen16(vr[u], vf, T());
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

template <typename T, int D>
static cudaError_t launch_decode(int B, const DecodeArgs& a, cudaStream_t stream) {
    const dim3 grid(a.H, B);
    decode_attn_kernel<T, D><<<grid, DS_DECODE_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
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
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_DECODE_D(T)                                                   \
    switch (D) {                                                         \
        case 32: return static_cast<int>(launch_decode<T, 32>(B, a, s));  \
        case 64: return static_cast<int>(launch_decode<T, 64>(B, a, s));  \
        case 128: return static_cast<int>(launch_decode<T, 128>(B, a, s)); \
        default: return static_cast<int>(cudaErrorInvalidValue);         \
    }
    switch (dtype) {
        case kF32: DS_DECODE_D(float)
        case kF16: DS_DECODE_D(__half)
        case kBF16: DS_DECODE_D(__nv_bfloat16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DS_DECODE_D
}
