// Shared half of the flash-attention backward kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu): the argument block, and the 16-byte tile loader of
// the FMA kernels, which run fp32 (flash_bwd_dq_kernel, flash_dkv_fma).
// bf16 and fp16 run flash_bwd_dq_tc and flash_bwd_dkv_tc on wgmma and TMA
// (hopper.cuh).
//
// The kernels recompute the probabilities from the forward's fp32
// logsumexp, p = exp(s * scale - lse) with s = q.k in fp32, and use the
// JAX package's rounding (flash_attention.py:359-367, :283-287): p rounded
// to the input dtype T before dV += p^T.dO, and
// dS = round_T(p * (dP - delta) * scale) before dK += dS^T.Q and
// dQ += dS.K.  delta = rowsum(dO * O) comes in precomputed (fp32,
// [B, H, Sq]), as the JAX package computes it outside Pallas.  Causal
// masking is end-aligned (key j visible to query i iff j <= i + Sk - Sq);
// a row that sees no key (causal Sq > Sk) has lse = -inf and is masked
// before the exponential, so its gradients come out 0, not NaN.  With
// kv_lens, key j of row b is visible only if j < max(1, kv_lens[b]) too:
// k-tiles wholly past that length are never loaded, and the dK and dV of
// padding keys are exactly 0.  With a window (causal only, GPT-Neo's
// local layers; JAX use_window) key j is visible to query i only if
// i + Sk - Sq - j < window as well: dQ's k-tile walk starts at the tile
// of its first row's band start and dK/dV's q-tile walk ends at the last
// row that sees its last key, so tiles wholly outside the band are never
// loaded, and only tiles that cross the band's lower edge are masked
// (JAX _block_crosses_mask with use_window).
//
// No kernel uses atomics: each output element is written by exactly
// one CTA, so one step's gradients are bitwise repeatable on the card.
#pragma once

#include "common.cuh"

#define DS_BWD_THREADS 128

struct BwdArgs {
    const void* q; const void* k; const void* v; const void* dout;
    const float* lse; const float* delta;   // [B, H, Sq] fp32, contiguous
    void* dq; void* dk; void* dv;
    int B, Sq, Sk, H;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long do_sb, do_ss, do_sh;
    long long dq_sb, dq_ss, dq_sh;
    long long dk_sb, dk_ss, dk_sh;
    long long dv_sb, dv_ss, dv_sh;
    float scale;
    int causal;
    const int* kv_lens;   // optional [B]: keys at or past max(1, kv_lens[b]) are padding
    int window;           // band width (causal only), 0: none
};

// the band applies: causal with a window
__host__ __device__ __forceinline__ bool banded(const BwdArgs& a) { return a.causal && a.window > 0; }

// the end of row b's live keys: Sk, or max(1, kv_lens[b]) clamped to Sk
__device__ __forceinline__ int key_limit(const BwdArgs& a, int b) {
    return a.kv_lens != nullptr ? min(a.Sk, max(1, a.kv_lens[b])) : a.Sk;
}

// rows [r0, r0 + ROWS) of a strided [S, D] head slice into shared memory as
// fp32 rows of DT >= D columns, with 16-byte loads (neighbouring threads on
// neighbouring addresses); rows at or past S, and the columns past D, are
// zero
template <typename T, int D, int ROWS, int DT = D>
__device__ __forceinline__ void load_rows(float4 (*dst)[DT / 4], const T* base, long long row_stride,
                                          int r0, int S) {
    constexpr int VEC = VecWidth<T>::value;
    constexpr int VPR = D / VEC;
    static_assert(VPR * VEC == D && DT >= D, "whole 16-byte vectors a row");
    if constexpr (DT > D)
        for (int id = threadIdx.x; id < ROWS * (DT - D) / 4; id += DS_BWD_THREADS)
            dst[id / ((DT - D) / 4)][D / 4 + id % ((DT - D) / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int id = threadIdx.x; id < ROWS * VPR; id += DS_BWD_THREADS) {
        const int j = id / VPR, vv = id % VPR;
        float f[VEC];
        if (r0 + j < S) {
            const uint4 raw = *reinterpret_cast<const uint4*>(base + (long long)(r0 + j) * row_stride + vv * VEC);
            widen16(raw, f, T());
        } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e)
            dst[j][vv * (VEC / 4) + e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void axpy4(float4& acc, float s, const float4& x) {
    acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}
