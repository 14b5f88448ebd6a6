"""int8 serving in the port (CPU, plain kernels) against the JAX package:
``quantize_params_int8`` picks the same leaves and gives the same codes
and scales for the bf16-cast weights; an int8 KV cache through
``prefill``/``extend``/``decode_step`` matches JAX ``gpt_inference`` in
fp32 (logits to 1e-4); the int8 engine's ``generate`` equals the module
loop it drives; ``SlotBatcher`` and the slot ops carry the scales; the
config takes ``dtype="int8"`` and ``kv_cache_dtype="int8"`` and refuses
what is not ported."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import quantization as jquant
from deepspeed_tpu.models import gpt_inference as jinf
from deepspeed_tpu.ops.pallas import decode_attention as jdecode
from deepspeed_tpu_torch.inference.quantization import (Int8Param,
                                                        param_bytes,
                                                        quantize_leaf,
                                                        quantize_params_int8)
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt_inference as tinf
from deepspeed_tpu_torch.ops.kernels import cached_attention
from deepspeed_tpu_torch.serving import ServingConfig, SlotBatcher

from .test_torch_gpt_inference import tiny_configs, tiny_params
from .test_torch_quantizer import assert_jit_close

TOL = 1e-4


def _assert_int8_cache_close(tc, jc):
    """An int8 cache filled by the port's forward against one filled by
    JAX's: the K/V going in agree to fp32 roundoff, so scales agree to
    ``TOL`` and a code may flip by 1 where K or V sits on a rounding
    boundary (none of these caches has more than a few)."""
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tc, name + "_scale").numpy(),
            np.asarray(getattr(jc, name + "_scale")), rtol=TOL, atol=0)
        diff = np.abs(getattr(tc, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jc, name)).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


@pytest.mark.parametrize("Sq,pos", [(1, 100), (1, [37, 200]), (8, 64),
                                    (8, [5, 180]), (16, [0, 239])])
def test_int8_cached_attention_matches_jax_kernels(pallas_interpret, Sq, pos):
    """The decode and chunk Pallas kernels' ``quantized`` option in
    interpret mode (S_max 256) against the port's plain path, which
    dequantizes the cache first; fp32, tolerance 1e-5."""
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 2, 64)).astype(np.float32)
    codes = [rng.integers(-127, 128, (2, 256, 2, 64)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.001, 0.02, (2, 256, 2, 1)).astype(np.float32)
              for _ in range(2)]
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    ref = jdecode.cached_attention(
        jnp.asarray(q), jnp.asarray(codes[0]), jnp.asarray(codes[1]), jpos,
        k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    out = cached_attention(torch.from_numpy(q), *map(torch.from_numpy, codes),
                           tpos, k_scale=torch.from_numpy(scales[0]),
                           v_scale=torch.from_numpy(scales[1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case,err,match", [
    ("bf16_cache", TypeError, "int8 codes"),
    ("scale_shape", ValueError, "scales must be fp32"),
    ("scale_dtype", ValueError, "scales must be fp32"),
    ("one_scale", TypeError, "k_scale, v_scale"),
    ("scales_to_plain_kernel", TypeError, "no scales"),
])
def test_int8_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, err,
                                                                  match):
    """The int8 wrappers' checks run before any build or launch, so they
    are exercised here on CPU tensors."""
    from deepspeed_tpu_torch.ops.kernels import decode_attn, decode_attn_int8
    q = torch.zeros(2, 1, 2, 64)
    ck = cv = torch.zeros(2, 16, 2, 64, dtype=torch.int8)
    ks = vs = torch.zeros(2, 16, 2, 1)
    kernel, scales = decode_attn_int8, (ks, vs)
    if case == "bf16_cache":
        ck = cv = torch.zeros(2, 16, 2, 64)
    elif case == "scale_shape":
        scales = (torch.zeros(2, 16, 2), vs)
    elif case == "scale_dtype":
        scales = (ks, vs.double())
    elif case == "one_scale":
        scales = (ks,)
    else:
        kernel = decode_attn
    with pytest.raises(err, match=match):
        kernel(q, ck, cv, 3, 0.125, *scales)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = tiny_configs()
    tree = tiny_params(jcfg, seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, convert.from_jax_params(tree), tree


def test_quantize_params_int8_matches_jax_on_bf16_weights(model):
    jcfg, jparams, tcfg, tparams, tree = model
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    tbf = convert.from_jax_params(tree, dtype=torch.bfloat16)
    jq, jn = jquant.quantize_params_int8(jbf)
    tq, tn = quantize_params_int8(tbf)
    assert tn == jn == 4
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, jquant.Int8Param))[0])
    jflat = {tuple(p.key for p in path): v for path, v in jflat.items()}
    for path, leaf in _leaves(tq):
        ref = jflat[path]
        assert isinstance(leaf, Int8Param) == isinstance(ref,
                                                         jquant.Int8Param)
        if not isinstance(leaf, Int8Param):
            continue
        assert path[-1] in ("wqkv", "wo", "wi", "wo_mlp")
        assert leaf.q.shape == ref.q.shape and leaf.scale.shape == \
            ref.scale.shape
        # the JAX engine's jitted quantize_leaf: XLA's reciprocal rewrite
        assert_jit_close(leaf.q, leaf.scale, ref.q, ref.scale)
        # the JAX function run eagerly: bitwise
        w = dict(_leaves(jbf))[path]
        eager = jquant.quantize_leaf(w)
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(eager.q))
        np.testing.assert_array_equal(leaf.scale.numpy(),
                                      np.asarray(eager.scale))
    # a JAX Int8Param tree converts to the port's, codes and scales intact
    conv = convert.from_jax_params(jax.device_get(jq))
    got = conv["blocks"]["wqkv"]
    assert isinstance(got, Int8Param) and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(),
                                  np.asarray(jq["blocks"]["wqkv"].q))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(jq["blocks"]["wqkv"].scale))


def test_int8_param_duck_types_a_weight(model):
    _, _, tcfg, tparams, _ = model
    w = tparams["blocks"]["wqkv"]
    p = quantize_leaf(w)
    assert p.shape == w.shape and p.ndim == w.ndim == 5
    assert p.device == w.device and p.dtype == torch.float32
    assert p.scale.shape == w.shape[:-1] + (1,)
    layer = p[1]
    assert isinstance(layer, Int8Param) and layer.shape == w.shape[1:]
    torch.testing.assert_close(layer.to(torch.float32),
                               p.to(torch.float32)[1], rtol=0, atol=0)
    back = p.to(torch.float32)
    assert back.dtype == torch.float32
    # 8-bit symmetric: every element within half a step of its scale
    assert ((back - w).abs() / p.scale).max() <= 0.5 + 1e-6
    assert p.to(torch.bfloat16).dtype == torch.bfloat16
    assert p.nbytes == w.numel() + 4 * w.numel() // w.shape[-1]


@pytest.mark.parametrize("step", ["decode_ragged", "decode_scalar",
                                  "extend_ragged", "extend_scalar"])
def test_int8_cache_matches_jax(model, step):
    """prefill into an int8 cache on both sides, then the same int8 cache
    (JAX's, copied into the port's) through one decode or extend step."""
    jcfg, jp, tcfg, tp, _ = model
    toks = np.random.default_rng(9).integers(0, 512, (2, 14)).astype(
        np.int32)
    jlg, jc = jinf.prefill(jp, jnp.asarray(toks), jcfg,
                           jinf.init_cache(jcfg, 2, 32, kv_dtype="int8"))
    tlg, tc = tinf.prefill(tp, torch.as_tensor(toks).long(), tcfg,
                           tinf.init_cache(tcfg, 2, 32, kv_dtype="int8"))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    assert tc.int8 and tc.k.dtype == torch.int8 and tc.length == 14
    _assert_int8_cache_close(tc, jc)
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(tc, name).copy_(torch.from_numpy(np.array(getattr(jc,
                                                                  name))))
    lengths = [7, 11]
    if step.startswith("decode"):
        nxt = np.asarray([3, 77], np.int32)
        kw = {"lengths": lengths} if step == "decode_ragged" else {}
        jkw = {"lengths": jnp.asarray(lengths, jnp.int32)} \
            if kw else {}
        jlg, jc = jinf.decode_step(jp, jnp.asarray(nxt), jcfg, jc, **jkw)
        tlg, tc = tinf.decode_step(tp, torch.as_tensor(nxt).long(), tcfg, tc,
                                   **kw)
    else:
        chunk = np.random.default_rng(10).integers(0, 512, (2, 4)).astype(
            np.int32)
        kw = {"lengths": lengths} if step == "extend_ragged" else {}
        jkw = {"lengths": jnp.asarray(lengths, jnp.int32)} \
            if kw else {}
        jlg, jc = jinf.extend(jp, jnp.asarray(chunk), jcfg, jc, **jkw)
        tlg, tc = tinf.extend(tp, torch.as_tensor(chunk).long(), tcfg, tc,
                              **kw)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    assert tc.length == int(jc.length)
    _assert_int8_cache_close(tc, jc)


def _greedy_loop(params, cfg, toks, lens, n, kv_dtype):
    """Ragged greedy decoding through the module functions."""
    B, S = toks.shape
    cache = tinf.init_cache(cfg, B, 64, kv_dtype=kv_dtype)
    last, cache = tinf.prefill(params, torch.as_tensor(toks).long(), cfg,
                               cache, logits_at=torch.as_tensor(lens) - 1)
    lengths, out = np.asarray(lens), []
    for _ in range(n):
        nxt = torch.argmax(last[:, :cfg.vocab_size], dim=-1)
        out.append(nxt)
        last, cache = tinf.decode_step(params, nxt, cfg, cache,
                                       lengths=lengths)
        lengths = lengths + 1
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("conf", [
    {"dtype": "int8", "kv_cache_dtype": "int8"}, {"dtype": "int8"},
    {"dtype": "bfloat16", "kv_cache_dtype": "int8"}])
def test_int8_engine_generate_equals_its_module_loop(model, conf):
    """The engine casts the weights to bf16, then quantizes them, and
    hands its KV dtype to the caches ``generate`` builds."""
    _, _, tcfg, _, tree = model
    eng = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)), conf, device="cpu")
    assert eng.model_config.dtype == torch.bfloat16
    weight_int8 = conf["dtype"] == "int8"
    assert isinstance(eng.params["blocks"]["wi"], Int8Param) == weight_int8
    assert eng.params["wte"].dtype == torch.bfloat16
    bf = convert.from_jax_params(tree, dtype=torch.bfloat16)
    params = quantize_params_int8(bf)[0] if weight_int8 else bf
    if weight_int8:
        torch.testing.assert_close(eng.params["blocks"]["wqkv"].q,
                                   params["blocks"]["wqkv"].q, rtol=0, atol=0)
    toks = np.random.default_rng(11).integers(0, 512, (3, 12))
    lens = [12, 7, 3]
    kv = conf.get("kv_cache_dtype")
    out = eng.generate(toks, max_new_tokens=10, prompt_lens=lens)
    ref = _greedy_loop(params, eng.model_config, toks, lens, 10,
                       "int8" if kv == "int8" else None)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert len(set(out[0].tolist())) >= 3


def test_int8_bytes_follow_the_shapes(model):
    """Parameter bytes and KV bytes per token per row, by shapes: codes 1
    byte and one fp32 scale per last-dim vector; K and V 1 byte per
    element plus one fp32 scale per head vector."""
    _, _, tcfg, _, tree = model
    bf = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)), {"dtype": "bfloat16"},
        device="cpu")
    i8 = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)),
        {"dtype": "int8", "kv_cache_dtype": "int8"}, device="cpu")
    L, d, f, H = tcfg.n_layer, tcfg.d_model, tcfg.ffn_dim, tcfg.n_head
    big = L * (3 * d * d + d * d + 2 * d * f)
    vectors = L * (3 * H * d + d + d + f)        # wqkv, wo, wi, wo_mlp rows
    assert param_bytes(bf.params) - param_bytes(i8.params) == \
        2 * big - (big + 4 * vectors)
    c16 = tinf.init_cache(bf.model_config, 1, 16)
    c8 = tinf.init_cache(i8.model_config, 1, 16, kv_dtype=i8._kv_dtype)
    per_tok = lambda c: sum(b.numel() * b.element_size()
                            for b in c.buffers()) // 16
    assert per_tok(c16) == L * 2 * d * 2
    assert per_tok(c8) == L * 2 * (d + 4 * H)


def test_slot_ops_carry_the_scales(model):
    _, _, tcfg, tp, _ = model
    toks = torch.as_tensor(np.random.default_rng(12).integers(0, 512, (1, 9)))
    small = tinf.prefill(tp, toks, tcfg,
                         tinf.init_cache(tcfg, 1, 32, kv_dtype="int8"))[1]
    big = tinf.write_slot(tinf.init_cache(tcfg, 3, 32, kv_dtype="int8"), 1,
                          small)
    for name in ("k", "v", "k_scale", "v_scale"):
        torch.testing.assert_close(getattr(big, name)[:, 1:2],
                                   getattr(small, name), rtol=0, atol=0)
        assert not getattr(big, name)[:, 0].any()
    assert big.k_scale[:, 1, :9].gt(0).all()
    back = tinf.read_slot(big, 1, length=9)
    assert back.int8 and back.length == 9
    tinf.reset_slot(big, 1)
    assert not any(b.any() for b in big.buffers())
    # read_slot was a copy
    torch.testing.assert_close(back.k_scale, small.k_scale, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tinf.write_slot(tinf.init_cache(tcfg, 3, 32), 0, small)


@pytest.fixture(scope="module")
def int8_cache_engine(model):
    _, _, tcfg, _, tree = model
    return deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)),
        {"dtype": "float32", "kv_cache_dtype": "int8"}, device="cpu")


def test_batcher_int8_cache_batched_equals_alone(int8_cache_engine):
    """Greedy requests through staggered slots equal each request alone
    in slot 0 (fp32 compute, int8 cache); both the slot and the scratch
    cache are int8."""
    bat = SlotBatcher(int8_cache_engine, ServingConfig(
        slots=3, max_len=64, prefill_chunk=8))
    assert bat.cache.int8 and bat._scratch.int8
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, (n,)) for n in (5, 13, 9)]
    got = {i: [] for i in range(3)}
    bat.admit(0, prompts[0], None, True, 1.0)
    for t in range(12):
        if t == 2:
            bat.admit(1, prompts[1], None, True, 1.0)
        if t == 4:
            bat.admit(2, prompts[2], None, True, 1.0)
        toks = bat.tick()
        for row, start in ((0, 0), (1, 2), (2, 4)):
            if t >= start:
                got[row].append(int(toks[row]))
    for i in range(3):
        bat.release(i)
    for i, p in enumerate(prompts):
        bat.admit(0, p, None, True, 1.0)
        alone = [int(bat.tick()[0]) for _ in range(len(got[i]))]
        bat.release(0)
        assert alone == got[i], i
        assert len(set(alone)) >= 3


def test_batcher_int8_prefix_equals_full_prompt(int8_cache_engine):
    """A shared prefix (a chunk multiple) holds codes and scales; an
    admission through it equals the admission of the whole prompt."""
    bat = SlotBatcher(int8_cache_engine, ServingConfig(
        slots=2, max_len=64, prefill_chunk=8))
    prompt = np.random.default_rng(14).integers(0, 512, (21,))
    prefix = bat.build_prefix(prompt[:16])
    assert prefix.cache.int8 and prefix.length == 16
    runs = []
    for pre in (prefix, None):
        bat.admit(0, prompt, None, True, 1.0, prefix=pre)
        runs.append([int(bat.tick()[0]) for _ in range(6)])
        bat.release(0)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("config,err,match", [
    ({"quant": {"int8_compute": True}, "dtype": "int8"}, NotImplementedError,
     "int8_compute"),
    ({"kv_cache_dtype": "fp8"}, ValueError, "kv_cache_dtype"),
    ({"quant": {"bits": 4}}, NotImplementedError, "bits"),
    ({"quant": {"no_such_key": 1}}, ValueError, "unknown config keys"),
])
def test_config_refuses_what_is_not_ported(model, config, err, match):
    _, _, tcfg, tp, _ = model
    with pytest.raises(err, match=match):
        deepspeed_tpu_torch.init_inference((tcfg, tp), config, device="cpu")


def test_config_accepts_the_int8_options():
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    c = DeepSpeedInferenceConfig.from_dict(
        {"dtype": "int8", "kv_cache_dtype": "int8",
         "quant": {"enabled": True, "bits": 8}})
    assert c.torch_dtype == torch.int8 and c.quantization.enabled
    assert dataclasses.asdict(c.quantization) == {
        "enabled": True, "bits": 8, "int8_compute": False}
