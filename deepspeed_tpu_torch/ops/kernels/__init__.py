"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper launches its kernel on CUDA tensors and runs the plain version
on CPU tensors (``utils.on_cuda``); ``launch_counts`` reads every
wrapper's count of kernel launches, and of its launches with each of its
options."""

from .block_sparse_attention import (block_sparse_attention,
                                     block_sparse_attention_backward,
                                     block_sparse_attention_backward_reference,
                                     block_sparse_attention_qkv,
                                     block_sparse_attention_reference,
                                     block_sparse_bwd_dkv, block_sparse_bwd_dq,
                                     block_sparse_fwd, config_plan,
                                     make_index_tables, sparse_plan)
from .decode_attention import (cached_attention, cached_attention_reference,
                               chunk_attn, chunk_attn_int8, decode_attn,
                               decode_attn_int8, dequantize_kv, quantize_kv,
                               quantize_kv_append, quantize_kv_into,
                               quantize_kv_into_reference)
from .flash_attention import (flash_attention, flash_attention_backward,
                              flash_attention_backward_reference,
                              flash_attention_qkv, flash_attention_reference,
                              flash_bwd_dkv, flash_bwd_dq, flash_bwd_fused,
                              flash_fwd, fused_backward, mha_reference)
from .fused_adam import (adam_hyper, fused_adam, fused_adam_kernel,
                         fused_adam_reference, fused_adam_step)
from .fused_bias_gelu import (bias_gelu_backward_reference,
                              bias_gelu_bwd, bias_gelu_dropout,
                              bias_gelu_forward_reference, bias_gelu_fwd,
                              keep_mask)
from .fused_lamb import (fused_lamb, fused_lamb_phase1, fused_lamb_phase2,
                         fused_lamb_reference, lamb_hyper)
from .quantizer import (dequantize, fake_quantize, quantize, quantize_rows,
                        quantizer_kernel)
from .spatial import (nhwc_bias_add, nhwc_bias_add_add,
                      nhwc_bias_add_bias_add, nhwc_bias_add_reference,
                      spatial_add_kernel, spatial_bias_add_kernel,
                      spatial_kernel)

#: every kernel wrapper of the port, by kernel name
KERNELS = {"flash_fwd": flash_fwd, "decode_attn": decode_attn,
           "chunk_attn": chunk_attn, "flash_bwd_dq": flash_bwd_dq,
           "flash_bwd_dkv": flash_bwd_dkv, "flash_bwd_fused": flash_bwd_fused,
           "fused_adam": fused_adam_kernel,
           "block_sparse_fwd": block_sparse_fwd,
           "block_sparse_bwd_dq": block_sparse_bwd_dq,
           "block_sparse_bwd_dkv": block_sparse_bwd_dkv,
           "fused_lamb_phase1": fused_lamb_phase1,
           "fused_lamb_phase2": fused_lamb_phase2, "quantizer": quantizer_kernel,
           "decode_attn_int8": decode_attn_int8,
           "chunk_attn_int8": chunk_attn_int8,
           "quantize_kv_append": quantize_kv_append,
           "nhwc_bias_add": spatial_kernel,
           "nhwc_bias_add_add": spatial_add_kernel,
           "nhwc_bias_add_bias_add": spatial_bias_add_kernel,
           "bias_gelu_fwd": bias_gelu_fwd, "bias_gelu_bwd": bias_gelu_bwd}


def launch_counts() -> dict:
    """Every wrapper's launches by kernel name, and under ``name[option]``
    (``flash_fwd[window]``, ``decode_attn[alibi]``, ...) its launches with
    that option."""
    counts = {name: type(k).launches for name, k in KERNELS.items()}
    for name, k in KERNELS.items():
        for opt, n in getattr(type(k), "option_launches", {}).items():
            counts[f"{name}[{opt}]"] = n
    return counts


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        type(k).launches = 0
        opts = getattr(type(k), "option_launches", {})
        for opt in opts:
            opts[opt] = 0


def head_dim_launches() -> dict:
    """The attention wrappers' launches at each head dim, by kernel name
    ({"flash_fwd": {64: n, 96: m}, ...}), counted since
    :func:`reset_head_dim_launches` (:func:`reset_launch_counts` leaves
    them, so that one reading can span several paths)."""
    return {name: dict(sorted(type(k).dim_launches.items()))
            for name, k in KERNELS.items() if hasattr(type(k), "dim_launches")}


def reset_head_dim_launches() -> None:
    for k in KERNELS.values():
        if hasattr(type(k), "dim_launches"):
            type(k).dim_launches.clear()


__all__ = ["KERNELS", "adam_hyper", "bias_gelu_backward_reference",
           "bias_gelu_bwd", "bias_gelu_dropout",
           "bias_gelu_forward_reference", "bias_gelu_fwd",
           "block_sparse_attention",
           "block_sparse_attention_backward",
           "block_sparse_attention_backward_reference",
           "block_sparse_attention_qkv", "block_sparse_attention_reference",
           "block_sparse_bwd_dkv", "block_sparse_bwd_dq", "block_sparse_fwd",
           "cached_attention", "config_plan",
           "cached_attention_reference", "chunk_attn", "chunk_attn_int8",
           "decode_attn", "decode_attn_int8", "dequantize", "dequantize_kv",
           "fake_quantize",
           "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_qkv",
           "flash_attention_reference", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_bwd_fused", "flash_fwd", "fused_adam", "fused_adam_kernel",
           "fused_adam_reference", "fused_adam_step", "fused_backward",
           "fused_lamb",
           "fused_lamb_phase1", "fused_lamb_phase2", "fused_lamb_reference",
           "head_dim_launches", "keep_mask", "lamb_hyper", "launch_counts",
           "make_index_tables", "mha_reference", "nhwc_bias_add",
           "nhwc_bias_add_add", "nhwc_bias_add_bias_add",
           "nhwc_bias_add_reference", "quantize", "quantize_kv",
           "quantize_kv_append", "quantize_kv_into",
           "quantize_kv_into_reference",
           "quantize_rows", "quantizer_kernel", "reset_head_dim_launches",
           "reset_launch_counts",
           "sparse_plan", "spatial_add_kernel", "spatial_bias_add_kernel",
           "spatial_kernel"]
