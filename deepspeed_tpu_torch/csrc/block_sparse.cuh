// Shared half of the block-sparse attention kernels (block_sparse_fwd.cu,
// block_sparse_bwd_dq.cu, block_sparse_bwd_dkv.cu): the argument block,
// the shared-memory row loader, the head-dim x chunk dispatch of the fp32
// FMA kernels, and the tile tables of the tensor-core kernels.
//
// Which kernel runs.  In bf16 and fp16 all three run on tensor cores
// (block_sparse_fwd_tc, block_sparse_bwd_dq_tc, block_sparse_bwd_dkv_tc:
// wgmma on TMA-fed 64-wide tiles, over the tile tables below).  fp32 runs
// the FMA kernels described next (wgmma transposes 16-bit operands only).
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
// The FMA kernels.  One CTA owns `rows` = min(128 / TPR, block) rows of one
// block (query rows for the forward and dq, key rows for dk/dv), TPR = DT/16
// neighbouring lanes per row, each lane holding four float4 chunks of the
// head dim (chunk c*TPR + t), as in flash_tile.cuh; so a CTA has 32 to 128
// threads.  DT = tile_dim(D) (common.cuh): D 80 and 96 padded to 128 with
// zeros, so TPR stays a power of two; the chunks past D hold zeros and are
// not stored.  It walks its block's live list, and inside each live block
// the other side in chunks of CHUNK = min(block, 64) rows (32 in the tile
// of 128), staged in shared memory as fp32.  Rows and chunks never cross a layout
// block, so the tiles are independent of the layout block size.  Every
// loop trip count is the CTA's (the live count, the block's chunks), so
// the full-mask shuffles that reduce a row's dot products never diverge.
//
// The tile table (make_tile_tables) recompiles the layout at the tensor
// cores' unit, a 64 x 64 tile (the wgmma M of one warpgroup): for each
// (head, 64-query tile) the ascending 64-key tiles that hold a live,
// causally visible pair, each entry packed as tile id | bits << 16, where
// bit (i * sub + j) says that sub-block (q sub-block i, k sub-block j) of
// the tile is live, sub = 64 / min(block, 64) (16 bits at block 16, 4 at
// 32, 1 at 64 and 128); their count; and the order of the units, heaviest
// first; this row table serves the forward and dQ.  The transposed table
// (per key tile, its q-tiles, the same bits) serves dK/dV.  S need not be a multiple of 64 at blocks 16 and 32: the
// sub-blocks past S have no bit, TMA zero-fills the rows past S, and the
// stores stop at S.
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

// rows [r0, r0 + ROWS) of one (b, h) slice into shared memory as fp32 rows
// of DT >= D columns, with 16-byte loads (neighbouring threads on
// neighbouring addresses); the rows lie inside one layout block, so all
// are in range; the columns past D are zero
template <typename T, int D, int ROWS, int DT = D>
__device__ __forceinline__ void stage_rows(float4 (*dst)[DT / 4], const View& src, int b, int h, int r0) {
    constexpr int VEC = VecWidth<T>::value;
    constexpr int VPR = D / VEC;
    static_assert(VPR * VEC == D && DT >= D, "whole 16-byte vectors a row");
    if constexpr (DT > D)
        for (int id = threadIdx.x; id < ROWS * (DT - D) / 4; id += blockDim.x)
            dst[id / ((DT - D) / 4)][D / 4 + id % ((DT - D) / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    constexpr int TPR = HeadDim<D>::TILE / 16;
    constexpr int max_rows = DS_SPARSE_THREADS / TPR;
    const int rows = a.block < max_rows ? a.block : max_rows;
    grid = dim3(a.S / rows, a.H, a.B);
    block = dim3(rows * TPR);
}

// the tensor-core kernels' table (one direction)
struct TileTable {
    const int* entries;         // [H, nt, width]: tile id | live sub-block bits << 16
    const int* cnt;             // [H, nt] live tiles
    const int* order;           // [H * nt] units h * nt + tile, heaviest first
    int width;
};

// log2 of the sub-block edge inside a 64-wide tile: 4, 5, or 6 (a whole
// tile) at blocks 64 and 128
__host__ __forceinline__ int sub_block_log(int block) {
    return block == 16 ? 4 : block == 32 ? 5 : 6;
}

// Is (query q, key k), positions inside one tile, visible: its sub-block
// is live (bl: sub_block_log) and, on a causal diagonal tile, k <= q.
__device__ __forceinline__ bool tile_visible(unsigned bits, int q, int k, int bl, bool diag) {
    return ((bits >> (((q >> bl) << (6 - bl)) + (k >> bl))) & 1u) & (!diag | (k <= q));
}

// the bits of a tile whose every sub-block is live
__device__ __forceinline__ unsigned all_live(int bl) { return (1u << (1 << (2 * (6 - bl)))) - 1u; }

__host__ __forceinline__ bool sparse_args_ok(const SparseArgs& a) {
    const bool block_ok = a.block == 16 || a.block == 32 || a.block == 64 || a.block == 128;
    return block_ok && a.S % a.block == 0 && a.width >= 1;
}

// the fp32 FMA kernels' launch by head dim and CHUNK = min(block, CMAX):
// 64 rows at D <= 64 and 32 in the tile of 128 (D 80, 96, 128) keep the
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
        case 80: DS_SPARSE_CHUNK(LAUNCH, T, 80, 32)                               \
        case 96: DS_SPARSE_CHUNK(LAUNCH, T, 96, 32)                               \
        case 128: DS_SPARSE_CHUNK(LAUNCH, T, 128, 32)                             \
        default: return cudaErrorInvalidValue;                                    \
    }
