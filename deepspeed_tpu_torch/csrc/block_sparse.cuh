// Shared half of the block-sparse attention kernels (block_sparse_fwd.cu,
// block_sparse_bwd_dq.cu, block_sparse_bwd_dkv.cu): the argument block, the
// shared-memory row loader and the dtype x head-dim x chunk dispatch.
//
// The layout is a per-head [H, n, n] 0/1 block mask over blocks of `block`
// positions (n = S / block), compiled on the host into ragged tables
// (ops/kernels/block_sparse_attention.py make_index_tables): for each
// (head, q-block) the ascending ids of its live k-blocks, idx [H, n, width],
// and their count, cnt [H, n]; the dk/dv kernel takes the transposed
// (column) tables in the same two arguments.  Causal layouts have their
// above-diagonal blocks dropped there, and the causal mask inside a live
// block is positional: key j is visible to query i iff j <= i.
//
// One CTA owns `rows` = min(128 / TPR, block) rows of one block (query rows
// for the forward and dq, key rows for dk/dv), TPR = D/16 neighbouring
// lanes per row, each lane holding four float4 chunks of the head dim
// (chunk c*TPR + t), as in flash_tile.cuh; so a CTA has 32 to 128 threads.
// It walks its block's live list, and inside each live block the other
// side in chunks of CHUNK = min(block, 64) rows (32 at D = 128), staged in
// shared memory as fp32.  Rows and chunks never cross a layout block, so
// the tiles are independent of the layout block size.  Every loop trip
// count is the CTA's (the live count, the block's chunks), so the
// full-mask shuffles that reduce a row's dot products never diverge.
#pragma once

#include "common.cuh"

#define DS_SPARSE_THREADS 128

// a [B, S, H, D] tensor with a unit-stride head dim, by its strides
struct View {
    const void* p;
    long long sb, ss, sh;
};

struct SparseArgs {
    View q, k, v, dout;
    View out0, out1;            // O (fwd), dQ (dq), or dK and dV (dkv)
    float* lse;                 // [B, H, S] fp32: written by fwd, read by bwd
    const float* delta;         // [B, H, S] fp32 rowsum(dO * O), bwd only
    const int* idx;             // [H, n, width] live block ids
    const int* cnt;             // [H, n] live block counts
    int width;
    int B, S, H, block;
    float scale;
    int causal;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const View& v, int b, int s, int h) {
    return static_cast<const T*>(v.p) + b * v.sb + (long long)s * v.ss + h * v.sh;
}

// rows [r0, r0 + ROWS) of one (b, h) slice into shared memory as fp32, with
// 16-byte loads (neighbouring threads on neighbouring addresses); the rows
// lie inside one layout block, so all are in range
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows(float4 (*dst)[D / 4], const View& src, int b, int h, int r0) {
    constexpr int VEC = VecWidth<T>::value;
    constexpr int VPR = D / VEC;
    const T* base = row_ptr<T>(src, b, r0, h);
    for (int id = threadIdx.x; id < ROWS * VPR; id += blockDim.x) {
        const int j = id / VPR, vv = id % VPR;
        float f[VEC];
        widen16(*reinterpret_cast<const uint4*>(base + (long long)j * src.ss + vv * VEC), f, T());
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e)
            dst[j][vv * (VEC / 4) + e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    }
}

__device__ __forceinline__ float dot4s(const float4& a, const float4& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void axpy4s(float4& acc, float s, const float4& x) {
    acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}

// the launch every kernel shares: `rows` rows of one layout block per CTA
template <int D>
__host__ __forceinline__ void sparse_grid(const SparseArgs& a, dim3& grid, dim3& block) {
    constexpr int max_rows = DS_SPARSE_THREADS / (D / 16);
    const int rows = a.block < max_rows ? a.block : max_rows;
    grid = dim3(a.S / rows, a.H, a.B);
    block = dim3(rows * (D / 16));
}

__host__ __forceinline__ bool sparse_args_ok(const SparseArgs& a) {
    const bool block_ok = a.block == 16 || a.block == 32 || a.block == 64 || a.block == 128;
    return block_ok && a.S % a.block == 0 && a.width >= 1;
}

// CHUNK = min(block, CMAX): 64 rows at D <= 64 and 32 at D = 128 keep the
// two staged fp32 tiles within 32 KB of static shared memory
#define DS_SPARSE_CHUNK(LAUNCH, T, DD, CMAX)                                      \
    switch (a.block < CMAX ? a.block : CMAX) {                                    \
        case 16: return LAUNCH<T, DD, 16>(a, stream);                             \
        case 32: return LAUNCH<T, DD, 32>(a, stream);                             \
        case 64: return LAUNCH<T, DD, (CMAX >= 64 ? 64 : 32)>(a, stream);         \
        default: return cudaErrorInvalidValue;                                    \
    }
#define DS_SPARSE_D(LAUNCH, T)                                                    \
    switch (D) {                                                                  \
        case 32: DS_SPARSE_CHUNK(LAUNCH, T, 32, 64)                               \
        case 64: DS_SPARSE_CHUNK(LAUNCH, T, 64, 64)                               \
        case 128: DS_SPARSE_CHUNK(LAUNCH, T, 128, 32)                             \
        default: return cudaErrorInvalidValue;                                    \
    }
#define DS_SPARSE_DISPATCH(LAUNCH)                                                \
    if (!sparse_args_ok(a)) return cudaErrorInvalidValue;                         \
    switch (dtype) {                                                              \
        case kF32: DS_SPARSE_D(LAUNCH, float)                                     \
        case kF16: DS_SPARSE_D(LAUNCH, __half)                                    \
        case kBF16: DS_SPARSE_D(LAUNCH, __nv_bfloat16)                            \
        default: return cudaErrorInvalidValue;                                    \
    }
