// flash_fwd: prefill attention with the fp32 logsumexp.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (line 133): online-softmax attention over [B, S, H, D],
// causal end-aligned (offset Sk - Sq), fp32 accumulation, p cast to the
// input dtype before P.V, O and the fp32 lse written (lse feeds the
// backward of the training slice).  kv_lens (optional, int32 [B]) masks
// the keys of row b at or past max(1, kv_lens[b]), the right padding of an
// MLM batch, and its k-tiles wholly past that length are never loaded.
//
// Bound on the H100: 4*D FLOPs per visible (q, k) pair against the bytes
// of q, k, v, O and lse read or written once.  With D = 64 that is about
// S/4 FLOPs per byte under causal masking, below the card's 295 bf16
// FLOPs per byte for every prompt width of the serving slice (S <= 1024),
// so the least time is the bytes over 3.35 TB/s.  This first version runs
// the products on fp32 FMAs (flash_tile.cuh) and is bound by their issue
// rate, far above that; what its design does about the bytes: each k-tile
// is read from device memory once per q-tile and shared by all BQ rows in
// shared memory, tiles above the causal diagonal are never visited, and
// the S x S score matrix never exists in device memory.
#include "flash_tile.cuh"

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* kv_lens, int dtype, int B, int Sq, int Sk, int H, int D,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal, void* stream) {
    if (B == 0 || Sq == 0 || H == 0) return 0;
    TileArgs a{q, k, v, o, lse, B, Sq, Sk, H,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
               scale, causal, nullptr, 0, kv_lens};
    return static_cast<int>(dispatch_tile<false>(dtype, D, a, static_cast<cudaStream_t>(stream)));
}
