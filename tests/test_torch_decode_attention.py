"""The port's cached attention (plain path, CPU) against the JAX
package's ``cached_attention``: the decode and chunk Pallas kernels in
interpret mode at S_max 256, the dense reference at shapes the TPU
kernels do not tile; with and without the band and ALiBi options.
fp32, tolerance 1e-5."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu_torch.ops.kernels import cached_attention

TOL = 1e-5


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _inputs(B, Sq, Smax, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Smax, H, D)).astype(np.float32),
            rng.standard_normal((B, Smax, H, D)).astype(np.float32))


def _both(jax_fn, q, ck, cv, pos):
    """(port output, JAX output) for scalar ``pos`` or a per-row list."""
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    ref = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                            jpos))
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    out = cached_attention(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv), tpos)
    return out.numpy(), ref


#: (Sq, pos) of the kernel parity cases: decode, then chunks, each with a
#: scalar and a ragged pos
CACHE_CASES = [(1, 100), (1, [37, 200]), (8, 64), (8, [5, 180]), (16, 130),
               (16, [0, 239])]


def _case_id(Sq, pos, i):
    return f"{Sq}-{pos if isinstance(pos, int) else f'pos{i}'}"


@pytest.mark.parametrize("Sq,pos,D", [
    pytest.param(Sq, pos, D, id=_case_id(Sq, pos, i)
                 + ("" if D == 64 else f"-D{D}"))
    for D in (64, 80, 96) for i, (Sq, pos) in enumerate(CACHE_CASES)])
def test_cached_attention_matches_jax_kernels(pallas_interpret, Sq, pos, D):
    """Head dim 64, and 80 and 96 (GPT-2 2.7B, 760M; the JAX kernels take
    any head dim as one block)."""
    from deepspeed_tpu.ops.pallas.decode_attention import cached_attention \
        as jax_cached
    q, ck, cv = _inputs(2, Sq, 256, 2, D, seed=Sq)
    out, ref = _both(jax_cached, q, ck, cv, pos)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Smax,Sq,pos", [
    (40, 1, 17), (40, 1, [3, 39]), (8, 3, 2), (24, 5, [0, 19]),
])
def test_cached_attention_untiled_shapes_match_reference(Smax, Sq, pos):
    """Shapes the TPU kernels do not tile (S_max not a 128 multiple, odd
    chunks): the JAX package takes its dense reference; every CUDA shape
    takes the port's kernels."""
    from deepspeed_tpu.ops.pallas.decode_attention import \
        cached_attention_reference
    q, ck, cv = _inputs(2, Sq, Smax, 3, 32, seed=Smax + Sq)
    out, ref = _both(cached_attention_reference, q, ck, cv, pos)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


#: low-precision chunks against the fp32 JAX function of the same rounded
#: inputs (times max(1, |ref|)): the plain version rounds p and O to the
#: input dtype, and dequantizes an int8 cache to it first
#: (chip_smoke.py's sweep tolerances)
LOW_TOL = {"bfloat16": 1e-2, "float16": 2e-3, "int8": 1e-2}


@pytest.mark.parametrize("Sq,pos,D", [
    *[pytest.param(Sq, pos, 64, id=f"{Sq}-{pos}") for Sq, pos in (
        (7, 0), (63, 0), (65, 0), (129, 0),          # q-tile 0 sees one k-tile
        (7, 249), (63, 193), (65, 191), (129, 127),  # pos + Sq = S_max
        (64, 192))],                                 # the JAX chunk kernel tiles
    pytest.param(65, [0, 191], 64, id="65-pos9"),    # ragged: one row at each end
    # head dims 80 and 96: one k-tile, the cache's end, the tiled chunk,
    # ragged rows
    *[pytest.param(Sq, pos, D, id=f"{Sq}-{pos}-D{D}" if isinstance(pos, int)
                   else f"{Sq}-ragged-D{D}")
      for D in (80, 96)
      for Sq, pos in ((65, 0), (129, 127), (64, 192), (65, [0, 191]))],
])
@pytest.mark.parametrize("cache", ["bfloat16", "float16", "int8"])
def test_chunk_tile_edges_low_precision(pallas_interpret, cache, Sq, pos, D):
    """The plain chunk path (what ``chip_smoke.py`` holds ``chunk_attn``
    and ``chunk_attn_int8`` against on the card) at the edges of the
    tensor-core kernel's 64-query and 64-key tiles, in bf16, fp16 and over
    an int8 cache (bf16 q), against the JAX package's ``cached_attention``
    in fp32 on the same rounded inputs: the Pallas chunk kernel in
    interpret mode where it tiles (Sq 64), its dense reference elsewhere.
    S_max 256; head dim 64, and 80 and 96 at four of the edges."""
    from deepspeed_tpu.ops.pallas.decode_attention import cached_attention \
        as jax_cached
    from deepspeed_tpu_torch.ops.kernels import quantize_kv
    dtype = torch.float16 if cache == "float16" else torch.bfloat16
    q, ck, cv = (torch.from_numpy(a).to(dtype)
                 for a in _inputs(2, Sq, 256, 2, D, seed=Sq * 7 + len(cache)))
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    jq = jnp.asarray(q.float().numpy())
    if cache == "int8":
        (kq, ks), (vq, vs) = quantize_kv(ck.float()), quantize_kv(cv.float())
        out = cached_attention(q, kq, vq, tpos, k_scale=ks, v_scale=vs)
        ref = jax_cached(jq, jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                         jpos, k_scale=jnp.asarray(ks.numpy()),
                         v_scale=jnp.asarray(vs.numpy()))
    else:
        out = cached_attention(q, ck, cv, tpos)
        ref = jax_cached(jq, jnp.asarray(ck.float().numpy()),
                         jnp.asarray(cv.float().numpy()), jpos)
    assert out.dtype == dtype and out.shape == q.shape
    ref = np.asarray(ref)
    err = np.abs(out.float().numpy() - ref).max() / max(1.0,
                                                       np.abs(ref).max())
    assert err <= LOW_TOL[cache], err


@pytest.mark.parametrize("option", [
    {"k_scale": 1, "v_scale": 1, "window": 4}, {"window": 4},
    {"slopes": 1}])
def test_unported_options_raise(option):
    """The window and ALiBi options of the cache kernels are ported: on
    the int8 cache too they give the JAX reference's output.  The windowed
    flash backward is ported too: its gradient no longer raises and equals
    autograd's through the plain banded forward."""
    from deepspeed_tpu.ops.pallas.decode_attention import \
        cached_attention_reference as jax_ref
    from deepspeed_tpu_torch.ops.kernels import (flash_attention,
                                                 flash_attention_reference,
                                                 quantize_kv)
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(1, 1, 16, 2, 32, 0))
    kw, jkw = {}, {}
    if "k_scale" in option:
        (ck, ks), (cv, vs) = quantize_kv(ck), quantize_kv(cv)
        kw.update(k_scale=ks, v_scale=vs)
        jck, jcv = (jnp.asarray((c.float() * s).numpy())
                    for c, s in ((ck, ks), (cv, vs)))
    else:
        jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    if "window" in option:
        kw["window"] = jkw["window"] = option["window"]
    if "slopes" in option:
        slopes = np.asarray([0.5, 0.25], np.float32)
        kw["slopes"], jkw["slopes"] = torch.from_numpy(slopes), \
            jnp.asarray(slopes)
    out = cached_attention(q, ck, cv, 3, **kw)
    ref = jax_ref(jnp.asarray(q.numpy()), jck, jcv, 3, **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    qkv = torch.randn(1, 8, 2, 32, generator=torch.Generator().manual_seed(1),
                      requires_grad=True)
    window = option.get("window", 2)
    o, _ = flash_attention(qkv, qkv, qkv, window=window)
    (got,) = torch.autograd.grad(o.sum(), qkv)
    o_ref, _ = flash_attention_reference(qkv, qkv, qkv, True, 32 ** -0.5,
                                         window=window)
    (want,) = torch.autograd.grad(o_ref.sum(), qkv)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


#: (Sq, pos) of the option cases: the decode kernel and the JAX chunk
#: kernel's 8-row tiles, scalar and ragged, rows before and past the band
OPTION_CASES = [(1, 100), (1, [3, 200]), (8, 64), (8, [0, 190]),
                (16, [5, 239])]


@pytest.mark.parametrize("Sq,pos", OPTION_CASES)
@pytest.mark.parametrize("option", ["window1", "window", "slopes",
                                    "slopes_window"])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_cached_attention_options_match_jax_kernels(pallas_interpret,
                                                    cache, option, Sq, pos):
    """``window`` (1: the diagonal only; 20) and ALiBi ``slopes`` through
    the plain path against the JAX package's ``cached_attention`` (its
    Pallas decode and chunk kernels in interpret mode, S_max 256), over an
    fp32 cache and over its int8 form.  fp32, tolerance 1e-5."""
    from deepspeed_tpu.ops.pallas.decode_attention import cached_attention \
        as jax_cached
    from deepspeed_tpu_torch.ops.kernels import quantize_kv
    q, ck, cv = _inputs(2, Sq, 256, 2, 64, seed=Sq + len(option))
    kw = {}
    if option.startswith("window"):
        kw["window"] = 1 if option == "window1" else 20
    if option.startswith("slopes"):
        kw["slopes"] = np.asarray([0.5, 0.0625], np.float32)
        if option == "slopes_window":
            kw["window"] = 20
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    jkw = {k: (jnp.asarray(v) if k == "slopes" else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if k == "slopes" else v)
           for k, v in kw.items()}
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    if cache == "int8":
        (kq, ks), (vq, vs) = quantize_kv(tk), quantize_kv(tv)
        out = cached_attention(tq, kq, vq, tpos, k_scale=ks, v_scale=vs,
                               **tkw)
        ref = jax_cached(jnp.asarray(q), jnp.asarray(kq.numpy()),
                         jnp.asarray(vq.numpy()), jpos,
                         k_scale=jnp.asarray(ks.numpy()),
                         v_scale=jnp.asarray(vs.numpy()), **jkw)
    else:
        out = cached_attention(tq, tk, tv, tpos, **tkw)
        ref = jax_cached(*map(jnp.asarray, (q, ck, cv)), jpos, **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("window", [1, 4, 300])
def test_window_at_least_the_position_is_causal(window):
    """Window 1 keeps the diagonal only; a window past every position is
    plain causal visibility."""
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(2, 5, 40, 2, 32, 7))
    pos = torch.tensor([0, 30], dtype=torch.int32)
    out = cached_attention(q, ck, cv, pos, window=window)
    if window >= 40:
        torch.testing.assert_close(out, cached_attention(q, ck, cv, pos),
                                   atol=0, rtol=0)
    elif window == 1:
        rows = torch.tensor([0, 30])[:, None] + torch.arange(5)
        want = cv[torch.arange(2)[:, None], rows]
        torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case,err,match", [
    ("int_dtype", TypeError, "not supported"),
    ("mixed_dtype", TypeError, "mixed dtypes"),
    ("head_dim_48", ValueError, "head dim 48"),
    ("strided_head_dim", ValueError, "contiguous"),
    ("misaligned_rows", ValueError, "16-byte aligned"),
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, err,
                                                             match):
    """The wrappers' checks run before any launch; they are plain Python,
    so they are exercised here on CPU tensors."""
    from deepspeed_tpu_torch.ops.kernels.utils import check_kernel_inputs
    q = torch.zeros(2, 4, 2, 64)
    k = torch.zeros(2, 8, 2, 64)
    if case == "int_dtype":
        q, k = q.int(), k.int()
    elif case == "mixed_dtype":
        k = k.half()
    elif case == "head_dim_48":
        q, k = q[..., :48].contiguous(), k[..., :48].contiguous()
    elif case == "strided_head_dim":
        k = torch.zeros(2, 8, 2, 128)[..., ::2]
    else:
        k = torch.zeros(2, 8, 2, 65)[..., 1:]
    with pytest.raises(err, match=match):
        check_kernel_inputs("decode_attn", q, k)
    assert check_kernel_inputs("decode_attn", torch.zeros(2, 4, 2, 64),
                               torch.zeros(2, 8, 2, 64)) == torch.float32
