// Hopper building blocks of the tensor-core attention kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu, flash_bwd_fused.cu,
// chunk_attn.cu, block_sparse_fwd.cu, block_sparse_bwd_dq.cu,
// block_sparse_bwd_dkv.cu; their shared consumer steps are in attn_tc.cuh)
// and of decode_attn.cu: TMA
// tensor maps and loads, mbarriers, warpgroup matrix products (wgmma) on
// shared-memory tiles, the swizzled layout for tiles that threads write
// themselves, and thread-block cluster helpers (rank, barrier, reads of a
// peer CTA's shared memory) for chunk_attn's and decode_attn's splits over
// the keys.
//
// Tiles.  A [rows, D] head slice of a 16-bit [B, S, H, D] tensor comes
// into shared memory through one TMA box per 64 columns (one box of 32
// columns at D 32): rows of 128 bytes under the 128-byte swizzle (64 bytes
// under the 64-byte swizzle at D 32), each box at a 1024-byte aligned
// base.  D 80 and 96 take D 128's two boxes (common.cuh tile_dim): the map's
// innermost extent is D, so TMA fills the second box's columns past D with
// zeros, and a load's transaction bytes are the whole boxes'.  wgmma reads such a tile in two ways:
//   K-major: the tile's rows are the M or N rows of the product and D is
//     its depth (S = Q.K^T: both operands);
//   MN-major (transposed): the tile's rows are the depth and D the N (or
//     M) columns (O += P.V: V, dK += dS^T.Q: Q; flash_bwd_fused's
//     dV += P^T.dO, dK += dS^T.Q: its [queries][keys] boxes of P and dS
//     as A, and dQ = dS.K: K as B, at D 64 each warpgroup's N = 32 half
//     of K's box from a start 64 bytes into the swizzled row).
// Both swizzles group 8 rows into one 1024- (512-) byte atom; the
// descriptor's two strides both hold that atom's size, which is the step
// between 8-row groups in either use, and neither operand spans more than
// one swizzle width in the other direction (products at N <= 64).
//
// Only the sources that include this header pay for <cuda.h>.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace hopper {

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library links nothing beyond cudart
static EncodeTiledFn encode_fn() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                             &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// map_rows's dtype for int8 cache codes (beside kF16, kBF16)
constexpr int kCodes = 3;

// A 4-D tiled map over a strided [B, S, H, D] tensor of esz-byte elements
// (strides in elements), dims innermost first (D, H, S, B), box (box0, 1,
// rows, 1).  A dim of extent 1 gets a stride of its own that TMA accepts,
// whatever the tensor's stride there.  Rows past S are zero-filled.
static cudaError_t encode_rows(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esz,
                               CUtensorMapSwizzle swizzle, int box0, int B, int S, int H, int D,
                               long long sb, long long ss, long long sh, int rows) {
    EncodeTiledFn fn = encode_fn();
    if (fn == nullptr) return cudaErrorNotSupported;
    cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    long long st[3] = {sh, ss, sb};
    cuuint64_t strides[3];
    cuuint64_t span = (cuuint64_t)D * esz;      // bytes one index of the dim covers at least
    for (int i = 0; i < 3; ++i) {
        strides[i] = dims[i + 1] == 1 ? ((span + 15) / 16) * 16 : (cuuint64_t)st[i] * esz;
        span = strides[i] * dims[i + 1];
    }
    cuuint32_t box[4] = {(cuuint32_t)box0, 1, (cuuint32_t)rows, 1};
    cuuint32_t estride[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, box, estride,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One [rows, D] tile of one (b, h) head slice per load set.  16-bit (kF16,
// kBF16): box (min(D, 64), 1, rows, 1), one [rows, 64] (or [rows, 32])
// tile under the 128-byte (64-byte) swizzle per load.  int8 codes
// (kCodes): box (D, 1, rows, 1), unswizzled, rows of D bytes one after
// another.
static cudaError_t map_rows(CUtensorMap* map, const void* base, int dtype, int B, int S, int H,
                            int D, long long sb, long long ss, long long sh, int rows) {
    const bool codes = dtype == kCodes;
    const CUtensorMapDataType type = codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    const CUtensorMapSwizzle swizzle = codes ? CU_TENSOR_MAP_SWIZZLE_NONE
                                       : D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                 : CU_TENSOR_MAP_SWIZZLE_64B;
    return encode_rows(map, base, type, codes ? 1 : 2, swizzle, codes || D < 64 ? D : 64, B, S, H, D, sb,
                       ss, sh, rows);
}

// One [rows, D] tile of one (b, h) head slice of esz-byte elements (1, 2
// or 4, moved as raw bits), unswizzled: rows of D elements one after
// another (decode_attn's stages).
static cudaError_t map_rows_linear(CUtensorMap* map, const void* base, int esz, int B, int S, int H,
                                   int D, long long sb, long long ss, long long sh, int rows) {
    const CUtensorMapDataType type = esz == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                : CU_TENSOR_MAP_DATA_TYPE_UINT32;
    return encode_rows(map, base, type, esz, CU_TENSOR_MAP_SWIZZLE_NONE, D, B, S, H, D, sb, ss, sh, rows);
}

// ---------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// add `bytes` to the transaction count the current phase waits for,
// without arriving (a later mbar_expect_tx arrives)
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    return done;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts ~2^32 cycles (seconds) can only be a fault of the kernel's
// barrier bookkeeping: it traps, so the launch fails with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(addr, parity))
        if (clock64() - start > (1ll << 32)) __trap();
}

// mbar_wait for code that runs after a setmaxnreg.inc: ptxas allocates
// such a region within its new register count only if no trap is reached
// from it (one __trap there kept a consumer at the launch's 168 registers,
// without a warning), so a wait that outlasts ~2^32 cycles stores to
// address 0 instead, and the launch fails with an illegal address
__device__ __forceinline__ void mbar_wait_no_trap(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(addr, parity))
        if (clock64() - start > (1ll << 32)) asm volatile("st.global.u32 [%0], %1;\n" ::"l"(0ull), "r"(0) : "memory");
}

// make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operands, TMA); the writer fences, then signals a barrier
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA loads (completion counted in bytes on `bar`)

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory by the bulk copy
// engine, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// order this thread's global accesses across the generic and the async
// proxy: an ld.acquire before a later bulk copy, a completed bulk write
// before a later st.release
__device__ __forceinline__ void fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from shared to global memory by the bulk
// copy engine, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     reinterpret_cast<uint64_t>(dst)),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
}

// dst[i] += src[i] over `bytes` of fp32 (a multiple of 16), the adds done
// in L2 by the bulk copy engine, in this thread's bulk group
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                     reinterpret_cast<uint64_t>(dst)),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// this thread's bulk groups have read their shared-memory sources
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk groups are complete, their global writes made
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// ---- register budgets of warp-specialised kernels: a warpgroup gives
// registers back (dec) or takes them (inc), every warp of it together,
// right after the branch on its role; ptxas allocates the code that
// follows within the new count

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Byte offset of 16-byte chunk `chunk` of row r in a tile with ROWB-byte
// rows under the 128-byte (ROWB 128) or 64-byte (ROWB 64) swizzle, the
// layout TMA writes and tile_desc describes: bits 4-6 (4-5) of the address
// are XORed with bits 7-9 (7-8).  For tiles written by threads.
template <int ROWB>
__device__ __forceinline__ uint32_t swizzled(int r, int chunk) {
    static_assert(ROWB == 128 || ROWB == 64, "swizzles of these kernels");
    const int phase = ROWB == 128 ? (r & 7) : ((r >> 1) & 3);
    return r * ROWB + (chunk ^ phase) * 16;
}

// barrier `id` (1-15; 0 is __syncthreads') over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// ---- thread-block clusters

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// Every thread of every CTA of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are visible to the peers'
// reads after it, and no CTA passes it while a peer has yet to arrive.
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of `p` (a shared variable of this CTA) in
// CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
    return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// arrive (release at cluster scope) on an mbarrier of a peer CTA, given
// its shared::cluster address: this thread's earlier writes, remote ones
// included, are visible to a thread that then waits on it with
// mbar_wait_cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

// mbar_wait with acquire at cluster scope: for barriers that peer CTAs
// arrive on (mbar_arrive_cluster); traps like mbar_wait
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    auto ready = [&]() {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        return done;
    };
    if (ready()) return;
    const long long start = clock64();
    while (!ready())
        if (clock64() - start > (1ll << 32)) __trap();
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
    return v;
}

// ---- wgmma

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (the exponentials of the softmax, as exp(y) = 2^(y log2 e))
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// byte offset of depth step kk (16 columns) in a K-major tile of R rows
// stored as boxes of 64 columns (D 128: step 4 starts the second box)
template <int R, int ROWB>
__device__ __forceinline__ uint32_t kstep(int kk) {
    return (kk / 4) * R * ROWB + (kk % 4) * 32;
}

// The shared-memory matrix descriptor of a swizzled 16-bit tile with
// ROWB-byte rows (128: 128-byte swizzle, 64: 64-byte swizzle), starting
// at `addr`; both strides are the 8-row atom (see the header comment).
template <int ROWB>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    constexpr uint64_t atom = (8 * ROWB) >> 4;
    constexpr uint64_t layout = ROWB == 128 ? 1 : 2;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (atom << 16) | (atom << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two fp32 values rounded to T and packed low-first: one 32-bit A-operand
// register of a 16-bit wgmma
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

#define DS_R16(d)                                                                            \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define DS_R32(d)                                                                            \
    DS_R16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DS_O16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DS_O32                                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D[64, N] (+)= A[64, 16] . B[16, N], A and B from shared memory, each
// K-major (0) or MN-major (1: transposed, its M or N rows contiguous and
// the depth as the tile's rows, as tile_desc describes an MN-major tile)
// as TA and TB say; fp32 accumulators, N/2 a thread.  accumulate = 0
// overwrites D.
template <typename T, int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
    static_assert(N == 32 || N == 64, "wgmma widths of these kernels");
    constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
    if constexpr (N == 64) {
        if constexpr (BF)
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_O32
                         ", %32, %33, p, 1, 1, %35, %36;\n}\n"
                         : DS_R32(d) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
        else
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DS_O32
                         ", %32, %33, p, 1, 1, %35, %36;\n}\n"
                         : DS_R32(d) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
    } else {
        if constexpr (BF)
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DS_O16
                         ", %16, %17, p, 1, 1, %19, %20;\n}\n"
                         : DS_R16(d) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
        else
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " DS_O16
                         ", %16, %17, p, 1, 1, %19, %20;\n}\n"
                         : DS_R16(d) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
    }
}

// D[64, N] += A[64, 16] . B[16, N], A from registers (four packed pairs
// in the accumulator's own layout), B from shared memory MN-major
// (transposed: N contiguous)
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
    static_assert(N == 32 || N == 64, "wgmma widths of these kernels");
    constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
    if constexpr (N == 64) {
        if constexpr (BF)
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_O32
                         ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                         : DS_R32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
        else
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DS_O32
                         ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                         : DS_R32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
        if constexpr (BF)
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DS_O16
                         ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                         : DS_R16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
        else
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                         "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " DS_O16
                         ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                         : DS_R16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
}

#undef DS_R16
#undef DS_R32

// ---- warp-level matrix products (mma.sync m16n8k16, fp32 accumulators)

// D[16, 8] += A[16, 16] . B[16, 8]: A row-major (a0: rows 0-7, a1: rows
// 8-15, a2 and a3 the same rows' columns 8-15), B column-major (b0: rows
// 0-7, b1: rows 8-15); thread t holds rows t/4 and t/4 + 8, columns
// 2 (t % 4) and 2 (t % 4) + 1 of each (A: of its 16 columns in two halves)
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                     "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
                     "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 16-bit matrices from shared memory, each row's 16 bytes at the
// address lane 8 i + r gives for row r of matrix i; thread t receives row
// t / 4, columns 2 (t % 4) and 2 (t % 4) + 1 of each (TRANS: of each
// matrix's transpose)
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    if constexpr (TRANS)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}


#undef DS_O16
#undef DS_O32

// The [64, N] fp32 accumulator fragment of a warpgroup: thread t holds,
// for each 8-column chunk j, (row, 8j + c), (row, 8j + c + 1),
// (row + 8, 8j + c), (row + 8, 8j + c + 1) at d[4j .. 4j + 3], with
// row = 16 * (t / 32) + (t % 32) / 4 and c = 2 * (t % 4).  A row's values
// sit in one quad of lanes.
struct Frag {
    int row, col;
    __device__ __forceinline__ explicit Frag(int t) : row(16 * (t >> 5) + ((t & 31) >> 2)), col(2 * (t & 3)) {}
};

// the sum (max) over the quad of lanes that holds a row
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// the A-operand registers of depth step kk (16 columns) of a [64, N]
// accumulator rounded to T: columns 16kk.. are chunks 2kk and 2kk + 1
template <typename T, int N>
__device__ __forceinline__ void to_operand(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        a[kk][0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
        a[kk][1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
        a[kk][2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
        a[kk][3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
    }
}

// Store a warpgroup's [64, N] accumulator rows (rows r0 + fragment row,
// columns c0 + ...) to a strided T matrix, times a per-row factor, rows
// at or past `limit` skipped, and the 8-column chunks at or past `cols`
// (a multiple of 8: the padded columns of a tile wider than the matrix;
// a constant once the caller's loops unroll).
template <typename T, int N>
__device__ __forceinline__ void store_frag(const float (&d)[N / 2], T* base, long long row_stride,
                                           int r0, int c0, int limit, float f0, float f1, const Frag& fr,
                                           int cols = N) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = r0 + fr.row + 8 * half;
        if (r >= limit) continue;
        const float f = half ? f1 : f0;
        T* p = base + (long long)r * row_stride + c0 + fr.col;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
            if (8 * j < cols)
                *reinterpret_cast<uint32_t*>(p + 8 * j) = pack2<T>(d[4 * j + 2 * half] * f, d[4 * j + 2 * half + 1] * f);
    }
}

}  // namespace hopper
