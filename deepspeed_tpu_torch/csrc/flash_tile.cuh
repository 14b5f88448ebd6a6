// The q-tile attention loop on fp32 FMAs, for the fp32 users that remain:
// flash_fwd with fp32 inputs, and chunk_attn / chunk_attn_int8 with fp32
// queries (over an fp32 or an int8 cache).  Their bf16 and fp16 paths run
// on wgmma and TMA (flash_fwd_tc in flash_fwd.cu, chunk_attn_tc in
// chunk_attn.cu), since wgmma reads a transposed operand (V) only in 16
// bits.
//
// One CTA of 128 threads owns a (b, h, q-tile).  A query row is held by
// TPR = DT/16 neighbouring lanes (DT = tile_dim(D): D 80 and 96 padded to
// 128 with zeros, so TPR stays a power of two and the row reductions'
// full-mask shuffles stay within a row), each owning four float4 chunks
// of the padded row (chunk c*TPR + t; the chunks past D hold zeros in q,
// K and V, and are not stored), so a warp's reads of a shared-memory K or V
// row touch TPR consecutive float4s and broadcast them to every row of
// the warp: no bank conflicts.  The CTA walks the k-tiles up to its
// causal frontier only; each k-tile is loaded once from device memory
// with 16-byte loads (neighbouring threads on neighbouring addresses),
// widened to fp32 in shared memory, and reused by all BQ rows of the
// tile.  Scores, the online-softmax state and the output accumulator stay
// in registers in fp32.  Inputs are read through their strides, so the
// [B, S, H, D] activations and the [B, S_max, H, D] layer view of the KV
// cache are used in place, with no transpose copy.
//
// With an int8 cache (chunk_attn_int8) K and V arrive as int8 codes and
// one fp32 scale per head vector; the tile load dequantizes them as
// code * scale in fp32 (JAX _chunk_kernel's order, decode_attention.py
// :258-260) on their way into shared memory, and nothing after it changes.
//
// The banded window (causal only; flash_attention.py _band_lower_mask,
// decode_attention.py :263-266): key j is visible to a row at position i
// only if i - j < window as well, and the CTA's k-tile walk starts at the
// tile holding its first row's band start, so tiles wholly below every
// row's band are never loaded.  ALiBi slopes (CHUNK only, :261-262): the
// score of head h gains -slopes[h] * (i - j) in fp32 after the scale.
//
// It multiplies with fp32 FMAs (67 TFLOP/s on the H100, no tensor cores)
// and is bound by their issue rate.
#pragma once

#include "common.cuh"

#define DS_TILE_THREADS 128

struct TileArgs {
    const void* q; const void* k; const void* v; void* o; float* lse;
    int B, Sq, Sk, H;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
    float scale;
    int causal;
    // CHUNK only: absolute position of query 0, per row (pos) or shared
    const int* pos;
    int pos_scalar;
    // flash only, optional: per-row key lengths [B] (keys at or past
    // max(1, kv_lens[b]) are padding)
    const int* kv_lens;
    // int8 cache only (C = int8_t): per-vector scales [B, S_max, H, 1]
    const float* k_scale; const float* v_scale;
    long long ks_sb, ks_ss, ks_sh;
    long long vs_sb, vs_ss, vs_sh;
    // optional: the band's width (0: none, causal only) and ALiBi's
    // per-head slopes [H] (nullptr: none)
    int window;
    const float* slopes;
};

// CHUNK = false: flash_attention.py _fwd_kernel semantics.  Causal is
//   end-aligned (key j visible to query i iff j <= i + Sk - Sq); with
//   kv_lens, key j of row b is visible only if j < max(1, kv_lens[b]) as
//   well, and the k-tiles wholly past that length are never loaded; the
//   running max starts at -inf; p is rounded to T before P.V; O and the
//   fp32 logsumexp are written.  Every loop bound depends on b and the
//   q-tile only, so it is uniform over the CTA.
// CHUNK = true: decode_attention.py _chunk_kernel semantics.  Query i sits
//   at absolute position pos[b] + i and sees cache slots <= pos[b] + i;
//   q is scaled before the product; the running max starts at M_FLOOR;
//   p stays fp32; only O is written.
// T is the type of q and O; C the type of the K and V it reads (T, or
// int8_t codes with k_scale/v_scale, CHUNK only).
template <typename T, int D, bool CHUNK, typename C = T>
__global__ void __launch_bounds__(DS_TILE_THREADS)
attn_tile_kernel(const TileArgs a) {
    constexpr bool Q8 = std::is_same<C, int8_t>::value;
    constexpr int DT = HeadDim<D>::TILE;          // the padded row
    constexpr int TPR = DT / 16;                  // lanes per query row
    constexpr int BQ = DS_TILE_THREADS / TPR;     // query rows per CTA
    constexpr int BK = DT <= 64 ? 64 : 32;        // keys per k-tile
    constexpr int NCH = 4;                        // float4 chunks per lane
    constexpr int VEC = VecWidth<C>::value;
    constexpr int VPR = D / VEC;                  // 16-byte vectors per row
    static_assert(VPR * VEC == D, "whole 16-byte vectors a row");
    __shared__ float4 ks[BK][DT / 4];
    __shared__ float4 vs[BK][DT / 4];

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int t = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int q0 = blockIdx.x * BQ;
    const int qi = q0 + r;
    const bool row_ok = qi < a.Sq;

    int off;
    bool masked;
    if (CHUNK) {
        off = a.pos ? a.pos[b] : a.pos_scalar;
        masked = true;
    } else {
        off = a.Sk - a.Sq;
        masked = a.causal != 0;
    }
    const int qpos = qi + off;                    // last visible key of the row
    // keys at or past klim are padding: never visible, never loaded
    const int klim = (!CHUNK && a.kv_lens != nullptr) ? min(a.Sk, max(1, a.kv_lens[b])) : a.Sk;
    int kend = klim;
    if (masked) {
        const int last_row = min(a.Sq, q0 + BQ) - 1;
        kend = max(0, min(klim, last_row + off + 1));
    }
    // the band: a row sees keys within win of its position; the walk
    // starts at the k-tile of the first row's band start
    const bool banded = masked && a.window > 0;
    const int win = banded ? a.window : INT_MAX;
    const int kbeg = banded ? max(0, q0 + off - win + 1) / BK * BK : 0;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;

    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)qi * a.q_ss + h * a.q_sh;
    const C* kp = static_cast<const C*>(a.k) + b * a.k_sb + h * a.k_sh;
    const C* vp = static_cast<const C*>(a.v) + b * a.v_sb + h * a.v_sh;

    // the padded columns of the tiles: zero, never written by the loads
    if constexpr (DT > D)
        for (int id = tid; id < BK * (DT - D) / 4; id += DS_TILE_THREADS) {
            const int j = id / ((DT - D) / 4), c4 = D / 4 + id % ((DT - D) / 4);
            ks[j][c4] = vs[j][c4] = make_float4(0.f, 0.f, 0.f, 0.f);
        }

    float4 q[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const bool col_ok = (c * TPR + t) * 4 < D;
        q[c] = row_ok && col_ok ? load4(qp + (c * TPR + t) * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        if (CHUNK) {
            q[c].x *= a.scale; q[c].y *= a.scale; q[c].z *= a.scale; q[c].w *= a.scale;
        }
    }
    float4 acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = CHUNK ? DS_M_FLOOR : -INFINITY;
    float l = 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        __syncthreads();                          // the previous tile is consumed
        for (int id = tid; id < BK * VPR; id += DS_TILE_THREADS) {
            const int j = id / VPR, vv = id % VPR;
            float kf[VEC], vf[VEC];
            if (k0 + j < klim) {
                const uint4 kr = *reinterpret_cast<const uint4*>(kp + (long long)(k0 + j) * a.k_ss + vv * VEC);
                const uint4 vr = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + j) * a.v_ss + vv * VEC);
                widen16(kr, kf, C());
                widen16(vr, vf, C());
                if constexpr (Q8) {
                    const float kscl = a.k_scale[b * a.ks_sb + (long long)(k0 + j) * a.ks_ss + h * a.ks_sh];
                    const float vscl = a.v_scale[b * a.vs_sb + (long long)(k0 + j) * a.vs_ss + h * a.vs_sh];
#pragma unroll
                    for (int e = 0; e < VEC; ++e) { kf[e] *= kscl; vf[e] *= vscl; }
                }
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
            }
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
                ks[j][vv * (VEC / 4) + e] = make_float4(kf[4 * e], kf[4 * e + 1], kf[4 * e + 2], kf[4 * e + 3]);
                vs[j][vv * (VEC / 4) + e] = make_float4(vf[4 * e], vf[4 * e + 1], vf[4 * e + 2], vf[4 * e + 3]);
            }
        }
        __syncthreads();

        float s[BK];
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            float part = 0.f;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                const float4 kv = ks[j][c * TPR + t];
                part += q[c].x * kv.x + q[c].y * kv.y + q[c].z * kv.z + q[c].w * kv.w;
            }
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
            if (!CHUNK) part *= a.scale;
            const int kj = k0 + j;
            part = fmaf(-slope, static_cast<float>(qpos - kj), part);   // ALiBi: 0 without slopes
            const bool vis = kj < klim && (!masked || (kj <= qpos && qpos - kj < win));
            s[j] = vis ? part : -INFINITY;
            tile_max = fmaxf(tile_max, s[j]);
        }
        const float m_new = fmaxf(m, tile_max);
        // a row with no visible key yet keeps m = -inf (flash only): guard
        // the subtraction so its p and alpha come out 0, not nan
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = expf(m - m_safe);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float p = expf(s[j] - m_safe);
            psum += p;
            s[j] = CHUNK ? p : round_to<T>(p);
        }
        l = l * alpha + psum;
        m = m_new;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
            acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
        }
#pragma unroll
        for (int j = 0; j < BK; ++j) {
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                const float4 vv = vs[j][c * TPR + t];
                acc[c].x += s[j] * vv.x; acc[c].y += s[j] * vv.y;
                acc[c].z += s[j] * vv.z; acc[c].w += s[j] * vv.w;
            }
        }
    }

    if (!row_ok) return;
    const float lf = fmaxf(l, 1e-30f);
    const float inv = 1.f / lf;
    T* op = static_cast<T*>(a.o) + b * a.o_sb + (long long)qi * a.o_ss + h * a.o_sh;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
        if ((c * TPR + t) * 4 < D)
            store4(op + (c * TPR + t) * 4, acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
    if (!CHUNK && t == 0 && a.lse != nullptr)
        a.lse[((long long)b * a.H + h) * a.Sq + qi] = m + logf(lf);
}

template <typename T, int D, bool CHUNK, typename C>
static cudaError_t launch_tile(const TileArgs& a, cudaStream_t stream) {
    constexpr int BQ = DS_TILE_THREADS / (HeadDim<D>::TILE / 16);
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    attn_tile_kernel<T, D, CHUNK, C><<<grid, DS_TILE_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

// the fp32 kernel at head dim D; Q8: the K and V it reads are int8 codes
// (chunk_attn_int8)
template <bool CHUNK, bool Q8 = false>
static cudaError_t dispatch_tile(int D, const TileArgs& a, cudaStream_t stream) {
    using C = typename std::conditional<Q8, int8_t, float>::type;
    switch (D) {
        case 32: return launch_tile<float, 32, CHUNK, C>(a, stream);
        case 64: return launch_tile<float, 64, CHUNK, C>(a, stream);
        case 80: return launch_tile<float, 80, CHUNK, C>(a, stream);
        case 96: return launch_tile<float, 96, CHUNK, C>(a, stream);
        case 128: return launch_tile<float, 128, CHUNK, C>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}
