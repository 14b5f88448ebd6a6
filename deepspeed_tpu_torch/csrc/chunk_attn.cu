// chunk_attn: a chunk of Sq queries over the padded KV cache.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// _chunk_kernel (line 218): query i of row b sits at absolute position
// pos[b] + i (pos scalar or per row) and sees cache slots <= pos[b] + i;
// fp32 math with q scaled first, running max floored at M_FLOOR, p kept
// in fp32.  chunk_attn_int8 is the kernel's int8-cache option (:258-260):
// int8 codes with one fp32 scale per head vector, dequantized as code *
// scale in fp32 as each cache tile is loaded (flash_tile.cuh).  The window
// and ALiBi options are not ported yet; the wrapper refuses them.
//
// Bound on the H100: a chunk of Sq queries does 4*D FLOPs per visible
// pair against 4*D bytes per live bf16 cache row (2*D + 8 for int8), about
// Sq FLOPs per byte: below the card's 295 bf16 FLOPs per byte for the
// slice's 128-token chunks, so the least time is the live-prefix bytes
// over 3.35 TB/s.
// This first version's fp32 FMAs (flash_tile.cuh) make it bound by FMA
// issue instead.  What its design does about the bytes: the cache is read
// through its strides in place (no [B*H, S_max, D] transpose copy per layer), each
// cache tile is read once per q-tile and shared by its rows in shared
// memory, and tiles beyond the chunk's causal frontier (pos + Sq - 1) are
// never loaded.
#include "flash_tile.cuh"

extern "C" int chunk_attn(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int Sq, int Smax, int H, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          const int* pos, int pos_scalar, float scale, void* stream) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    TileArgs a{q, k, v, o, nullptr, B, Sq, Smax, H,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
               scale, 1, pos, pos_scalar};
    return static_cast<int>(dispatch_tile<true>(dtype, D, a, static_cast<cudaStream_t>(stream)));
}

// k, v: int8 codes; k_scale, v_scale: fp32 [B, S_max, H, 1] through strides
extern "C" int chunk_attn_int8(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int Sq, int Smax, int H, int D,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long o_sb, long long o_ss, long long o_sh,
                               const float* k_scale, const float* v_scale,
                               long long ks_sb, long long ks_ss, long long ks_sh,
                               long long vs_sb, long long vs_ss, long long vs_sh,
                               const int* pos, int pos_scalar, float scale, void* stream) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    TileArgs a{q, k, v, o, nullptr, B, Sq, Smax, H,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
               scale, 1, pos, pos_scalar, nullptr, k_scale, v_scale,
               ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
    return static_cast<int>(
        dispatch_tile<true, true>(dtype, D, a, static_cast<cudaStream_t>(stream)));
}
