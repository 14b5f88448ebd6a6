// quantizer: grouped quantization to int8 codes with one fp32 scale (and
// offset) per group; quantize_kv_append: the same quantization of new K and
// V head vectors, written straight into an int8 KV cache.
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
// the design does about it:
// - Vector path (rows 16-byte aligned, gsize a multiple of the 16-byte
//   vector): a team of lanes sized to the group's bytes owns a group,
//   gsize * sizeof(T) / 16 lanes rounded up to a power of two and capped
//   at a warp, each lane one 16-byte load per step.  Up to 16 vectors a
//   lane (4,096 bf16 elements a warp, every leaf of GPT-2 350M) stay in
//   registers between the min/max reduction (shuffles over the team) and
//   the code pass, so the group is read from HBM once; codes leave as one
//   4-byte (fp32 input) or 8-byte (16-bit input) store per vector.  Larger
//   groups take a CTA per group that loops over the vectors twice (the
//   second pass from L2).
// - Scalar path, inside the same entry points: rows that are not 16-byte
//   aligned, or a gsize that is not a multiple of the vector (gsize 1,
//   100, ...): a team of 8 lanes, a warp or a CTA per group, one element a
//   lane per step, the group read twice.
//
// quantize_kv_append: the int8 KV cache's write (the JAX package's
// quantize_kv and then dynamic_update_slice / .at[rows, cols].set, fused
// by XLA under jit) in one launch per layer: the 8-bit symmetric
// deterministic branch over every head vector of the new tokens' K and V,
// read from the strided qkv view, codes and scales stored into the layer's
// cache slots pos[b] + i through the cache's strides.  A decode step's K
// and V for 8 rows and 16 heads are 256 groups of 64 in one launch, where
// quantize_kv and indexed writes would take two launches and four more
// kernels.
#include "common.cuh"

#include <initializer_list>
#include <utility>

#define DS_QUANT_THREADS 256
#define DS_QUANT_MAX_PER 16   // 16-byte vectors a lane keeps in registers

namespace {

struct QuantMath {
    float qmax;
    int symmetric;
    int stochastic;
    uint32_t seed_lo, seed_hi;
};

// grouped quantization: rows of [n0, n1, n2] through strides, contiguous
// codes [rows, gsize], scales and offsets [rows]
struct BulkRows {
    const void* x;
    int8_t* q;
    float* scale;
    float* offset;        // or null: not written
    long long rows, gsize;
    long long n1, n2;     // rows = n0 * n1 * n2 (row-major)
    long long xs0, xs1, xs2;  // element strides of the three row dims

    __device__ __forceinline__ bool exists(long long r) const { return r < rows; }
    __device__ __forceinline__ bool writes(long long r) const { return r < rows; }
    template <typename T>
    __device__ __forceinline__ const T* src(long long r) const {
        if (n1 == 1 && n2 == 1) return static_cast<const T*>(x) + r * xs0;   // no 64-bit divisions
        const long long i2 = r % n2, i1 = (r / n2) % n1, i0 = r / (n2 * n1);
        return static_cast<const T*>(x) + i0 * xs0 + i1 * xs1 + i2 * xs2;
    }
    __device__ __forceinline__ int8_t* codes(long long r) const { return q + r * gsize; }
    __device__ __forceinline__ float* scale_at(long long r) const { return scale + r; }
    __device__ __forceinline__ float* offset_at(long long r) const {
        return offset != nullptr ? offset + r : nullptr;
    }
};

// quantize_kv_append: group r = ((b * Sq + i) * H + h) * 2 + kv is head h
// of new token i of row b, K (kv = 0) or V (kv = 1); it lands in cache slot
// pos[b] + i (pos scalar when pos is null).  Slots outside [0, Smax) are
// skipped, so a bad per-row pos on the device cannot write out of bounds.
struct KvAppendRows {
    const void* k; const void* v;
    long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
    int8_t* kc; int8_t* vc;
    long long kc_sb, kc_ss, kc_sh, vc_sb, vc_ss, vc_sh;
    float* ks; float* vs;
    long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
    const int* pos;
    int pos_scalar;
    unsigned Sq, H;
    int Smax;
    long long rows, gsize;          // rows < 2^31 (the wrapper's entry checks)

    struct Where { int kv, b, i, h; };
    __device__ __forceinline__ Where where(long long r) const {
        Where w;
        const unsigned u = static_cast<unsigned>(r);
        w.kv = static_cast<int>(u & 1u);
        const unsigned t = u >> 1, th = t / H;
        w.h = static_cast<int>(t - th * H);
        w.b = static_cast<int>(th / Sq);
        w.i = static_cast<int>(th - static_cast<unsigned>(w.b) * Sq);
        return w;
    }
    __device__ __forceinline__ int slot(const Where& w) const {
        return (pos != nullptr ? pos[w.b] : pos_scalar) + w.i;
    }
    __device__ __forceinline__ bool exists(long long r) const { return r < rows; }
    // the source loads need no pos: only the stores wait for it
    __device__ __forceinline__ bool writes(long long r) const {
        if (r >= rows) return false;
        const int sl = slot(where(r));
        return sl >= 0 && sl < Smax;
    }
    template <typename T>
    __device__ __forceinline__ const T* src(long long r) const {
        const Where w = where(r);
        return w.kv ? static_cast<const T*>(v) + w.b * v_sb + w.i * v_ss + w.h * v_sh
                    : static_cast<const T*>(k) + w.b * k_sb + w.i * k_ss + w.h * k_sh;
    }
    __device__ __forceinline__ int8_t* codes(long long r) const {
        const Where w = where(r);
        const long long sl = slot(w);
        return w.kv ? vc + w.b * vc_sb + sl * vc_ss + w.h * vc_sh
                    : kc + w.b * kc_sb + sl * kc_ss + w.h * kc_sh;
    }
    __device__ __forceinline__ float* scale_at(long long r) const {
        const Where w = where(r);
        const long long sl = slot(w);
        return w.kv ? vs + w.b * vs_sb + sl * vs_ss + w.h * vs_sh
                    : ks + w.b * ks_sb + sl * ks_ss + w.h * ks_sh;
    }
    __device__ __forceinline__ float* offset_at(long long) const { return nullptr; }
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
// warp; TEAM > 32: the whole CTA); symmetric mode needs only the max.
// Every lane of the CTA must arrive (`symmetric` is the same for all).
template <int TEAM>
__device__ __forceinline__ void team_minmax(float& lo, float& hi, int symmetric) {
    constexpr int W = TEAM < 32 ? TEAM : 32;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
        if (!symmetric) lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
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

__device__ __forceinline__ void accumulate(float v, int symmetric, float& lo, float& hi) {
    if (symmetric) {
        hi = fmaxf(hi, fabsf(v));
    } else {
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
    }
}

// the group's scale and offset from its reduced min/max; lane 0 stores them
template <typename Rows>
__device__ __forceinline__ void scale_offset(const Rows& a, const QuantMath& m, long long r, int lane,
                                             float lo, float hi, float& scale, float& offset) {
    if (m.symmetric) {
        scale = fmaxf(hi / m.qmax, 1e-12f);
        offset = 0.f;
    } else {
        scale = fmaxf((hi - lo) / (2.f * m.qmax), 1e-12f);
        offset = (hi + lo) / 2.f;
    }
    if (lane == 0) {
        *a.scale_at(r) = scale;
        float* op = a.offset_at(r);
        if (op != nullptr) *op = offset;
    }
}

__device__ __forceinline__ int8_t code_of(float v, const QuantMath& m, float scale, float offset,
                                          unsigned long long idx) {
    float s = (m.symmetric ? v : v - offset) / scale;   // x - 0 is x, bitwise
    if (m.stochastic) s += sr_noise(idx, m.seed_lo, m.seed_hi);
    s = fminf(fmaxf(rintf(s), -m.qmax), m.qmax);
    return static_cast<int8_t>(__float2int_rn(s));
}

// VecWidth<T> codes of one 16-byte vector of T, stored as one 4-byte (fp32
// input) or 8-byte (16-bit input) word
template <typename T>
__device__ __forceinline__ void store_codes(const uint4& raw, const QuantMath& m, float scale,
                                            float offset, unsigned long long idx, int8_t* dst) {
    constexpr int VEC = VecWidth<T>::value;
    float f[VEC];
    widen16(raw, f, T());
    uint32_t w[VEC / 4];
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) w[j] = 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
        w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(code_of(f[e], m, scale, offset, idx + e)))
                    << (8 * (e % 4));
    if constexpr (VEC == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
        *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// The vector path, one group per TEAM lanes (TEAM <= 32), each lane
// holding vectors lane, lane + TEAM, ... (at most PER) in registers.
template <typename T, int TEAM, int PER, typename Rows>
__global__ void __launch_bounds__(DS_QUANT_THREADS)
quant_vec(const Rows a, const QuantMath m) {
    constexpr int VEC = VecWidth<T>::value;
    constexpr int PER_CTA = DS_QUANT_THREADS / TEAM;
    const int lane = threadIdx.x % TEAM;
    const long long r = static_cast<long long>(blockIdx.x) * PER_CTA + threadIdx.x / TEAM;
    const int nvec = static_cast<int>(a.gsize / VEC);
    uint4 raw[PER];
    float lo = INFINITY, hi = -INFINITY;
    if (a.exists(r)) {
        const T* xp = a.template src<T>(r);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int vi = i * TEAM + lane;
            if (vi < nvec) raw[i] = __ldg(reinterpret_cast<const uint4*>(xp + vi * VEC));
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            if (i * TEAM + lane < nvec) {
                float f[VEC];
                widen16(raw[i], f, T());
#pragma unroll
                for (int e = 0; e < VEC; ++e) accumulate(f[e], m.symmetric, lo, hi);
            }
        }
    }
    // every lane (rows past the end too) takes part in the reduction
    team_minmax<TEAM>(lo, hi, m.symmetric);
    if (!a.writes(r)) return;
    float scale, offset;
    scale_offset(a, m, r, lane, lo, hi, scale, offset);
    int8_t* qp = a.codes(r);
    const unsigned long long base = static_cast<unsigned long long>(r) * a.gsize;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int vi = i * TEAM + lane;
        if (vi < nvec) store_codes<T>(raw[i], m, scale, offset, base + vi * VEC, qp + vi * VEC);
    }
}

// The vector path for groups beyond a warp's registers: a CTA per group,
// looping over its vectors for the min/max and again for the codes.
template <typename T, typename Rows>
__global__ void __launch_bounds__(DS_QUANT_THREADS)
quant_vec_cta(const Rows a, const QuantMath m) {
    constexpr int VEC = VecWidth<T>::value;
    const long long r = blockIdx.x;
    const int nvec = static_cast<int>(a.gsize / VEC);
    const bool ok = a.exists(r);
    const T* xp = ok ? a.template src<T>(r) : nullptr;
    float lo = INFINITY, hi = -INFINITY;
    if (ok) {
        for (int vi = threadIdx.x; vi < nvec; vi += DS_QUANT_THREADS) {
            float f[VEC];
            widen16(__ldg(reinterpret_cast<const uint4*>(xp + vi * VEC)), f, T());
#pragma unroll
            for (int e = 0; e < VEC; ++e) accumulate(f[e], m.symmetric, lo, hi);
        }
    }
    team_minmax<DS_QUANT_THREADS>(lo, hi, m.symmetric);
    if (!a.writes(r)) return;
    float scale, offset;
    scale_offset(a, m, r, threadIdx.x, lo, hi, scale, offset);
    int8_t* qp = a.codes(r);
    const unsigned long long base = static_cast<unsigned long long>(r) * a.gsize;
    for (int vi = threadIdx.x; vi < nvec; vi += DS_QUANT_THREADS)
        store_codes<T>(__ldg(reinterpret_cast<const uint4*>(xp + vi * VEC)), m, scale, offset,
                       base + vi * VEC, qp + vi * VEC);
}

// The scalar path: one element a lane per step, the group read twice.
template <typename T, int TEAM, typename Rows>
__global__ void __launch_bounds__(DS_QUANT_THREADS)
quant_scalar(const Rows a, const QuantMath m) {
    constexpr int PER_CTA = DS_QUANT_THREADS / TEAM;
    const int lane = threadIdx.x % TEAM;
    const long long r = static_cast<long long>(blockIdx.x) * PER_CTA + threadIdx.x / TEAM;
    const bool ok = a.exists(r);
    const T* xp = ok ? a.template src<T>(r) : nullptr;
    float lo = INFINITY, hi = -INFINITY;
    if (ok)
        for (long long e = lane; e < a.gsize; e += TEAM) accumulate(to_float(xp[e]), m.symmetric, lo, hi);
    team_minmax<TEAM>(lo, hi, m.symmetric);
    if (!a.writes(r)) return;
    float scale, offset;
    scale_offset(a, m, r, lane, lo, hi, scale, offset);
    int8_t* qp = a.codes(r);
    const unsigned long long base = static_cast<unsigned long long>(r) * a.gsize;
    for (long long e = lane; e < a.gsize; e += TEAM)
        qp[e] = code_of(to_float(xp[e]), m, scale, offset, base + e);
}

template <int GROUPS_PER_CTA>
long long ctas(long long rows) { return (rows + GROUPS_PER_CTA - 1) / GROUPS_PER_CTA; }

template <typename T, int TEAM, int PER, typename Rows>
cudaError_t launch_vec(const Rows& a, const QuantMath& m, cudaStream_t s) {
    const long long blocks = ctas<DS_QUANT_THREADS / TEAM>(a.rows);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    quant_vec<T, TEAM, PER, Rows><<<static_cast<unsigned>(blocks), DS_QUANT_THREADS, 0, s>>>(a, m);
    return cudaGetLastError();
}

template <typename T, int TEAM, typename Rows>
cudaError_t launch_scalar(const Rows& a, const QuantMath& m, cudaStream_t s) {
    const long long blocks = ctas<DS_QUANT_THREADS / TEAM>(a.rows);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    quant_scalar<T, TEAM, Rows><<<static_cast<unsigned>(blocks), DS_QUANT_THREADS, 0, s>>>(a, m);
    return cudaGetLastError();
}

// Pick the path and the team.  `aligned`: every source row starts on a
// 16-byte boundary and every code row on a vector's width of codes.
template <typename T, typename Rows>
cudaError_t dispatch(const Rows& a, const QuantMath& m, bool aligned, cudaStream_t s) {
    constexpr int VEC = VecWidth<T>::value;
    if (aligned && a.gsize % VEC == 0) {
        const long long nvec = a.gsize / VEC;
        if (nvec <= 1) return launch_vec<T, 1, 1>(a, m, s);
        if (nvec <= 2) return launch_vec<T, 2, 1>(a, m, s);
        if (nvec <= 4) return launch_vec<T, 4, 1>(a, m, s);
        if (nvec <= 8) return launch_vec<T, 8, 1>(a, m, s);
        if (nvec <= 16) return launch_vec<T, 16, 1>(a, m, s);
        if (nvec <= 32) return launch_vec<T, 32, 1>(a, m, s);
        if (nvec <= 64) return launch_vec<T, 32, 2>(a, m, s);
        if (nvec <= 128) return launch_vec<T, 32, 4>(a, m, s);
        if (nvec <= 256) return launch_vec<T, 32, 8>(a, m, s);
        if (nvec <= 32 * DS_QUANT_MAX_PER) return launch_vec<T, 32, DS_QUANT_MAX_PER>(a, m, s);
        if (a.rows > 0x7fffffffLL) return cudaErrorInvalidValue;
        quant_vec_cta<T, Rows><<<static_cast<unsigned>(a.rows), DS_QUANT_THREADS, 0, s>>>(a, m);
        return cudaGetLastError();
    }
    if (a.gsize <= 8) return launch_scalar<T, 8>(a, m, s);
    if (a.gsize <= 4096) return launch_scalar<T, 32>(a, m, s);
    return launch_scalar<T, DS_QUANT_THREADS>(a, m, s);
}

template <typename Rows>
int dispatch_dtype(int dtype, const Rows& a, const QuantMath& m, bool aligned, cudaStream_t s) {
    switch (dtype) {
        case kF32: return static_cast<int>(dispatch<float>(a, m, aligned, s));
        case kF16: return static_cast<int>(dispatch<__half>(a, m, aligned, s));
        case kBF16: return static_cast<int>(dispatch<__nv_bfloat16>(a, m, aligned, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int elem_size(int dtype) { return dtype == kF32 ? 4 : 2; }

// a pointer plus element offsets that move along dims of extent > 1 keeps
// `align`-byte alignment
bool rows_aligned(const void* p, int esz, int align, std::initializer_list<std::pair<long long, long long>> dims) {
    if (reinterpret_cast<uintptr_t>(p) % align) return false;
    for (const auto& d : dims)
        if (d.first > 1 && (d.second * esz) % align) return false;
    return true;
}

}  // namespace

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
    const BulkRows a{x, static_cast<int8_t*>(q), scale, offset, rows, gsize, n1, n2, xs0, xs1, xs2};
    const QuantMath m{static_cast<float>((1 << (bits - 1)) - 1), symmetric, stochastic,
                      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)};
    const int esz = elem_size(dtype);
    const bool aligned = rows_aligned(x, esz, 16, {{n0, xs0}, {n1, xs1}, {n2, xs2}}) &&
                         reinterpret_cast<uintptr_t>(q) % 16 == 0;
    return dispatch_dtype(dtype, a, m, aligned, static_cast<cudaStream_t>(stream));
}

// k, v: the new tokens' [B, Sq, H, D] (dtype, strides in elements, each
// head vector contiguous); kc, vc: a cache layer's int8 codes [B, Smax, H,
// D] and ks, vs its fp32 scales [B, Smax, H, 1], through their strides;
// token i of row b goes to slot pos[b] + i (pos null: pos_scalar + i).
extern "C" int quantize_kv_append(const void* k, const void* v, int dtype,
                                  int B, int Sq, int H, int D, int Smax,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh,
                                  void* kc, void* vc,
                                  long long kc_sb, long long kc_ss, long long kc_sh,
                                  long long vc_sb, long long vc_ss, long long vc_sh,
                                  float* ks, float* vs,
                                  long long ks_sb, long long ks_ss, long long ks_sh,
                                  long long vs_sb, long long vs_ss, long long vs_sh,
                                  const int* pos, int pos_scalar, void* stream) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    const long long rows = 2LL * B * Sq * H;
    if (D <= 0 || B < 0 || Sq < 0 || H < 0 || rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const KvAppendRows a{k, v, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                         static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
                         kc_sb, kc_ss, kc_sh, vc_sb, vc_ss, vc_sh,
                         ks, vs, ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh,
                         pos, pos_scalar, static_cast<unsigned>(Sq), static_cast<unsigned>(H), Smax, rows, D};
    const QuantMath m{127.f, 1, 0, 0u, 0u};
    const int esz = elem_size(dtype);
    const int cw = 16 / esz;   // bytes of codes per 16-byte vector of input
    const bool aligned =
        rows_aligned(k, esz, 16, {{B, k_sb}, {Sq, k_ss}, {H, k_sh}}) &&
        rows_aligned(v, esz, 16, {{B, v_sb}, {Sq, v_ss}, {H, v_sh}}) &&
        rows_aligned(kc, 1, cw, {{B, kc_sb}, {Smax, kc_ss}, {H, kc_sh}}) &&
        rows_aligned(vc, 1, cw, {{B, vc_sb}, {Smax, vc_ss}, {H, vc_sh}});
    return dispatch_dtype(dtype, a, m, aligned, static_cast<cudaStream_t>(stream));
}
