"""OPT, GPT-NeoX and GPT-J in the port (CPU, plain kernels) against the
JAX package's ``gpt`` and ``gpt_inference`` on tiny fp32 models whose
weights are drawn with numpy and fed to both sides.

The layouts are the JAX ``GPTConfig`` variants the three injection
policies produce: OPT (relu, learned positions stored at offset 2), NeoX
(rotary over a quarter of each head, half split; parallel residual; an
untied head) and GPT-J (interleaved rotary over half of each head;
parallel residual; an untied head with a bias), plus ``pos_embed="none"``.
Helpers to ``FN_TOL``, logits to ``TOL`` (``test_torch_gpt_variants.py``'s
tolerances), a loss to ``FN_TOL`` and each gradient to ``TOL`` times
max(1, its largest element), a step over an int8 cache to
``INT8_STEP_TOL``, a bf16 step to ``BF16_REL_TOL`` relative L2 (both
packages round bf16 activations, in other places).  The port-only checks
(decode against the full forward, ragged prompts, the batcher, the
gateway) mirror the JAX package's ``tests/unit/inference/test_policies.py``
and the gateway's gates; one NeoX checkpoint crosses from the JAX engine
to the port's."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import gpt_inference as jinf
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu.runtime.model import from_gpt as jfrom_gpt
from deepspeed_tpu_torch.inference.quantization import Int8Param
from deepspeed_tpu_torch.models import convert, gpt, gpt_inference as tinf
from deepspeed_tpu_torch.runtime.model import from_gpt
from deepspeed_tpu_torch.serving import ServingConfig, SlotBatcher
from tests.unit.common import base_config, make_mesh, random_tokens

from .test_torch_gpt_inference import tiny_params
from .test_torch_gpt_variants import INT8_STEP_TOL

TOL = 2e-4
FN_TOL = 1e-5
BF16_REL_TOL = 2e-2
#: one sequence length for the whole file (the JAX side compiles each
#: eager op once per shape), a multiple of the sparse layout's block 16;
#: the cache holds the prompt and one 6-token chunk past it
SEQ = 32
CACHE_LEN = 48

BASE = dict(vocab_size=512, max_seq_len=64, n_layer=2, n_head=4, d_model=64)
#: the three policies' layouts (head dim 16: NeoX rotates 4 dims, GPT-J 8)
FAMILIES = {
    "opt": dict(activation="relu", pos_offset=2),
    "neox": dict(pos_embed="rotary", rotary_pct=0.25, parallel_residual=True,
                 tie_word_embeddings=False),
    "gptj": dict(pos_embed="rotary", rotary_pct=0.5, rotary_interleaved=True,
                 parallel_residual=True, tie_word_embeddings=False,
                 lm_head_bias=True),
}
LAYOUTS = {**FAMILIES, "none": dict(pos_embed="none")}


def _configs(layout, dtype=jnp.float32, **kw):
    jcfg = jgpt.GPTConfig(**BASE, **LAYOUTS[layout], dtype=dtype, **kw)
    return jcfg, convert.config_from_jax(jcfg)


def family_tree(jcfg, seed):
    """``tiny_params`` in the layout's tree: ``wpe`` with the offset's
    rows (none under rotary or "none"), and the untied head's ``lm_head``
    and ``lm_head_bias``."""
    tree = tiny_params(jcfg, seed)
    rng = np.random.default_rng(seed + 100)

    def n(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    del tree["wpe"]
    if jcfg.pos_embed == "learned":
        tree["wpe"] = n(jcfg.max_seq_len + jcfg.pos_offset, jcfg.d_model)
    if not jcfg.tie_word_embeddings:
        tree["lm_head"] = n(jcfg.padded_vocab, jcfg.d_model)
        if jcfg.lm_head_bias:
            tree["lm_head_bias"] = n(jcfg.padded_vocab)
    return tree


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jcfg, tcfg = _configs(request.param)
    tree = family_tree(jcfg, seed=3)
    return request.param, jcfg, _jax_tree(tree), tcfg, \
        convert.from_jax_params(tree)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


# ------------------------------------------------------------ the helpers

@pytest.mark.parametrize("positions", ["shared", "per_row"])
@pytest.mark.parametrize("pct", [1.0, 0.25])
@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["neox_half_split", "gptj_interleaved"])
def test_rotate_matches_jax(interleaved, pct, positions):
    """``_rotate`` on [2, 7, 3, 32] at shared [S] positions or per-row
    [B, S] ones far into the sequence (angles of ~2000 rad)."""
    jcfg = jgpt.GPTConfig(**BASE, pos_embed="rotary", rotary_pct=pct,
                          rotary_interleaved=interleaved, rotary_base=500.0)
    tcfg = convert.config_from_jax(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(7) if positions == "shared" else \
        np.asarray([[3], [2040]]) + np.arange(7)
    ref = jgpt._rotate(jnp.asarray(x), jnp.asarray(pos), jcfg)
    out = gpt._rotate(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FN_TOL,
                               rtol=FN_TOL)
    rot = int(32 * pct) // 2 * 2
    np.testing.assert_array_equal(out.numpy()[..., rot:], x[..., rot:])


@pytest.mark.parametrize("activation", list(gpt.ACTIVATIONS))
def test_activation_matches_jax(activation):
    jcfg = jgpt.GPTConfig(**BASE, activation=activation)
    x = np.random.default_rng(2).standard_normal((4, 33)).astype(
        np.float32) * 3
    ref = jgpt._activation_fn(jnp.asarray(x), jcfg)
    out = gpt._activation_fn(torch.from_numpy(x),
                             convert.config_from_jax(jcfg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FN_TOL,
                               rtol=FN_TOL)


def test_init_tree_follows_the_jax_tree():
    """``gpt.init``'s leaves and shapes are ``jgpt.init``'s for every
    layout: the offset ``wpe``, the untied head and its bias."""
    for layout in LAYOUTS:
        jcfg, tcfg = _configs(layout)
        want = jax.eval_shape(lambda: jgpt.init(jcfg, jax.random.PRNGKey(0)))
        got = gpt.init(tcfg)
        flat_w = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                  jax.tree_util.tree_leaves_with_path(want)}
        flat_g = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                  jax.tree_util.tree_leaves_with_path(got)}
        assert flat_g == flat_w, layout


# ----------------------------------------------------------- whole models

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_apply_matches_jax(layout):
    jcfg, tcfg = _configs(layout)
    tree = family_tree(jcfg, seed=4)
    toks = _tokens(2, SEQ, 0)
    ref = jgpt.apply(_jax_tree(tree), jnp.asarray(toks), jcfg)
    out = gpt.apply(convert.from_jax_params(tree), _t(toks), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


_JAX_GRADS = {}


def _jax_grads(jcfg, tree, tokens):
    """``jax.value_and_grad`` of the JAX ``loss_fn``, once per config and
    weights (the plain and remat cases share it)."""
    key = (jcfg, tree["wte"].tobytes(), tokens.tobytes())
    if key not in _JAX_GRADS:
        _JAX_GRADS[key] = jax.value_and_grad(jgpt.loss_fn)(
            _jax_tree(tree), {"tokens": jnp.asarray(tokens)}, jcfg)
    return _JAX_GRADS[key]


def _grads_match(jcfg, tcfg, tree, tokens):
    """The port's loss and every gradient against ``jax.value_and_grad``
    of the JAX ``loss_fn`` on the same weights and tokens."""
    jloss, jgrads = _jax_grads(jcfg, tree, tokens)
    params = convert.from_jax_params(tree)
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    loss = gpt.loss_fn(params, {"tokens": _t(tokens)}, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=FN_TOL, atol=FN_TOL)
    got = convert.to_numpy_params(
        jax.tree_util.tree_map(lambda p: p.grad, params))
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(want[path])
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= TOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("remat", [False, True],
                         ids=["plain", "remat_attn_out"])
def test_gradients_match_jax(family, remat):
    """Loss and gradients (the untied head's leaves too); under remat
    ``attn_out`` the backward re-runs each block's rotation and replays
    its saved O and lse."""
    _, jcfg, _, tcfg, _ = family
    if remat:
        tcfg = dataclasses.replace(tcfg, remat=True, remat_policy="attn_out")
    _grads_match(jcfg, tcfg, family_tree(jcfg, seed=5),
                 _tokens(2, SEQ + 1, 6))


@pytest.mark.parametrize("layout", ["neox", "gptj"])
def test_chunked_loss_on_the_untied_head(layout):
    """``loss_chunk`` 8 of 32: each chunk's logits come from ``lm_head``
    (and ``lm_head_bias``), whose gradients sum over the chunks."""
    jcfg, tcfg = _configs(layout, loss_chunk=8)
    assert tcfg.loss_chunk == 8
    _grads_match(jcfg, tcfg, family_tree(jcfg, seed=7),
                 _tokens(2, SEQ + 1, 8))


@pytest.mark.parametrize("route", ["window", "block_sparse"])
def test_rotary_composes_with_the_attention_routes(route):
    """GPT-J's rotary under GPT-Neo's alternating window 4 (the flash
    kernel's window option) and under a Fixed block-sparse layout (block
    16): loss and gradients against the JAX package, which rotates before
    ``_attention`` on either route."""
    kw = dict(local_attention_window=4, local_attention_alternating=True) \
        if route == "window" else dict(sparse_attention=FixedSparsityConfig(
            num_heads=4, block=16, num_local_blocks=2,
            attention="unidirectional"))
    jcfg, tcfg = _configs("gptj", **kw)
    tcfg = dataclasses.replace(tcfg, remat=True, remat_policy="attn_out")
    _grads_match(jcfg, tcfg, family_tree(jcfg, seed=9),
                 _tokens(2, SEQ + 1, 10))


# --------------------------------------------------------- cached decode

def _copy_cache(tc, jc):
    for name in ("k", "v") + (("k_scale", "v_scale") if tc.int8 else ()):
        getattr(tc, name).copy_(torch.from_numpy(
            np.asarray(getattr(jc, name).astype(jnp.float32))))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


_JAX_PREFILLS = {}


@pytest.mark.parametrize("kv,step", [
    ("fp32", "decode_ragged"), ("fp32", "decode_scalar"),
    ("fp32", "extend_ragged"), ("fp32", "extend_scalar"),
    ("bf16", "decode_ragged"), ("bf16", "extend_ragged"),
    ("int8", "decode_ragged"), ("int8", "extend_ragged")])
def test_cached_steps_match_jax(family, kv, step):
    """``prefill`` on both sides (logits and the rotated K/V cache), then
    JAX's cache copied into the port's (an int8 code may flip on a
    rounding tie) and one ``decode_step`` or ``extend`` at per-row or
    shared positions, with a cache in fp32, in bf16 (bf16 compute) or in
    int8."""
    name, jcfg, jp, tcfg, tp = family
    if kv == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    kv_dtype = "int8" if kv == "int8" else None
    toks = _tokens(2, SEQ, 9)
    if (name, kv) not in _JAX_PREFILLS:
        _JAX_PREFILLS[name, kv] = jinf.prefill(
            jp, jnp.asarray(toks), jcfg,
            jinf.init_cache(jcfg, 2, CACHE_LEN, kv_dtype=kv_dtype))
    jlg, jc = _JAX_PREFILLS[name, kv]
    tlg, tc = tinf.prefill(tp, _t(toks), tcfg,
                           tinf.init_cache(tcfg, 2, CACHE_LEN,
                                           kv_dtype=kv_dtype))

    def close(got, want, tol):
        if kv == "bf16":
            assert _rel_l2(np.asarray(got, np.float32),
                           np.asarray(want, np.float32)) <= BF16_REL_TOL
        else:
            np.testing.assert_allclose(got, np.asarray(want), atol=tol,
                                       rtol=tol)

    close(tlg.numpy(), jlg, TOL)
    if kv == "fp32":
        close(tc.k.numpy(), jc.k, TOL)
        close(tc.v.numpy(), jc.v, TOL)
    _copy_cache(tc, jc)
    lengths = [19, 27]
    ragged = step.endswith("ragged")
    kw = {"lengths": lengths} if ragged else {}
    jkw = {"lengths": jnp.asarray(lengths, jnp.int32)} if ragged else {}
    if step.startswith("decode"):
        nxt = np.asarray([3, 77], np.int32)
        jlg, jc = jinf.decode_step(jp, jnp.asarray(nxt), jcfg, jc, **jkw)
        tlg, tc = tinf.decode_step(tp, _t(nxt), tcfg, tc, **kw)
    else:
        chunk = _tokens(2, 6, 10)
        jlg, jc = jinf.extend(jp, jnp.asarray(chunk), jcfg, jc, **jkw)
        tlg, tc = tinf.extend(tp, _t(chunk), tcfg, tc, **kw)
    close(tlg.numpy(), jlg, INT8_STEP_TOL if kv == "int8" else TOL)
    assert tc.length == int(jc.length)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_matches_full_forward(layout):
    """Prefill 8 tokens, decode 4: each step's logits equal the full
    forward's at that position (JAX ``test_policies.py::
    test_variant_decode_matches_full_forward``)."""
    jcfg, tcfg = _configs(layout)
    tp = convert.from_jax_params(family_tree(jcfg, seed=11))
    toks = _t(_tokens(2, 12, 12))
    full = gpt.apply(tp, toks, tcfg)
    cache = tinf.init_cache(tcfg, 2, 32)
    _, cache = tinf.prefill(tp, toks[:, :8], tcfg, cache)
    for i in range(8, 12):
        lg, cache = tinf.decode_step(tp, toks[:, i], tcfg, cache)
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=f"step {i}")


def test_ragged_prompts_match_per_row_generation(family):
    """Right-padded prompts of 3 and 7 tokens with ``prompt_lens``
    generate what each prompt generates alone (JAX ``test_policies.py::
    test_ragged_prompts_match_per_row_generation``): per-row rotary and
    learned positions through prefill and decode."""
    _, _, _, tcfg, tp = family
    eng = deepspeed_tpu_torch.init_inference((tcfg, tp), {"dtype": "float32"},
                                             device="cpu")
    rng = np.random.default_rng(0)
    p1, p2 = rng.integers(3, 512, 3), rng.integers(3, 512, 7)
    padded = np.zeros((2, 7), np.int64)
    padded[0, :3], padded[1] = p1, p2
    ragged = eng.generate(padded, max_new_tokens=5, prompt_lens=[3, 7])
    for row, p in enumerate((p1, p2)):
        solo = eng.generate(p[None], max_new_tokens=5)
        assert ragged[row].tolist() == solo[0].tolist(), row


def test_batcher_equals_generate(family):
    """A SlotBatcher with 8-token prefill chunks (extends at each slot's
    own positions) and staggered admissions: each greedy request equals
    its prompt alone in the batcher and a ``generate`` of it."""
    _, _, _, tcfg, tp = family
    eng = deepspeed_tpu_torch.init_inference((tcfg, tp), {"dtype": "float32"},
                                             device="cpu")
    prompts = [_tokens(1, n, 20 + n)[0] for n in (13, 5, 19)]
    bat = SlotBatcher(eng, ServingConfig(slots=2, max_len=48,
                                         prefill_chunk=8))
    got = {0: [], 1: [], 2: []}
    bat.admit(0, prompts[0], None, True, 1.0)
    bat.admit(1, prompts[1], None, True, 1.0)
    for _ in range(4):
        toks = bat.tick()
        got[0].append(int(toks[0]))
        got[1].append(int(toks[1]))
    bat.release(1)
    bat.admit(1, prompts[2], None, True, 1.0)
    for _ in range(4):
        toks = bat.tick()
        got[0].append(int(toks[0]))
        got[2].append(int(toks[1]))
    for i, n in ((0, 8), (1, 4), (2, 4)):
        bat.release(0)
        bat.release(1)
        bat.admit(0, prompts[i], None, True, 1.0)
        alone = [int(bat.tick()[0]) for _ in range(n)]
        assert got[i] == alone, (i, got[i], alone)
        gen = eng.generate(prompts[i][None], max_new_tokens=n)[0]
        assert gen.tolist() == alone, (i, gen.tolist(), alone)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_gateway_storm_on_neox_equals_sessions(kv):
    """10 requests through 3 slots of a NeoX engine's gateway: every
    reply bitwise equal to the request alone in a session (with an int8
    cache, appended in the gateway's prefill chunks)."""
    jcfg, tcfg = _configs("neox")
    conf = {"dtype": "float32"}
    if kv:
        conf["kv_cache_dtype"] = kv
    eng = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(family_tree(jcfg, seed=13))), conf,
        device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, int(rng.integers(3, 24))),
             int(rng.integers(4, 14))) for _ in range(10)]
    with eng.serve(config={"slots": 3, "max_len": 64, "prefill_chunk": 8,
                           "queue_capacity": 16,
                           "idle_wait_s": 0.01}) as gw:
        handles = [gw.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = [h.result(timeout=60) for h in handles]
    for (prompt, n), out in zip(reqs, outs):
        s = eng.start_session(batch=1, max_len=64)
        if kv is None:
            s.append(prompt[None])
        else:
            for i in range(0, len(prompt), 8):
                s.append(prompt[None, i:i + 8])
        np.testing.assert_array_equal(out, s.generate(max_new_tokens=n)[0])


def test_int8_serving_quantizes_the_untied_head():
    """``dtype="int8"``: ``lm_head`` becomes an ``Int8Param`` beside
    ``wqkv``, ``wo``, ``wi``, ``wo_mlp`` and ``lm_head_bias`` stays in the
    serving dtype (JAX ``inference/quantization.py:43, 108``); the logits
    against the JAX int8 engine's at ``INT8_STEP_TOL`` times their scale
    (bf16 compute on both sides)."""
    jcfg, tcfg = _configs("gptj")
    tree = family_tree(jcfg, seed=15)
    conf = {"dtype": "int8"}
    jeng = deepspeed_tpu.init_inference(model=(jcfg, _jax_tree(tree)),
                                        config=dict(conf))
    teng = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)), dict(conf), device="cpu")
    assert isinstance(teng.params["lm_head"], Int8Param)
    assert teng.params["lm_head_bias"].dtype == torch.bfloat16
    assert not isinstance(teng.params["wte"], Int8Param)
    toks = _tokens(2, 16, 16)
    ref = np.asarray(jeng(toks), np.float32)
    out = teng(toks).numpy()
    assert _rel_l2(out, ref) <= BF16_REL_TOL


# ------------------------------------------------------------ checkpoints

def test_neox_tag_from_jax_resumes_in_port(tmp_path):
    """A NeoX model's tag, saved by the JAX engine (8-device CPU mesh,
    micro 1 x dp 8) after 2 of 3 fp32 Adam steps, carries ``lm_head``;
    a port engine built from another seed loads it and its third step's
    loss and every master leaf match the JAX engine's straight run at
    1e-5."""
    jcfg = jgpt.GPTConfig(**{**BASE, "vocab_size": 256}, **FAMILIES["neox"],
                          dtype=jnp.float32)
    cfg = base_config(micro_batch=1, stage=1, extra={"optimizer": {
        "type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.01}}})
    jeng, *_ = deepspeed_tpu.initialize(model=jfrom_gpt(jcfg), config=cfg,
                                        mesh_manager=make_mesh(dp=8),
                                        rng=jax.random.PRNGKey(42))
    batches = [random_tokens(8, 16, seed=1 + i) for i in range(3)]
    d = str(tmp_path)
    for i, b in enumerate(batches):
        if i == 2:
            jeng.save_checkpoint(d)
        loss = jeng.forward(b)
        jeng.backward(loss)
        jeng.step()
    want_loss = float(loss)
    want = jax.device_get(jeng.state["master"])
    assert "lm_head" in want
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(convert.config_from_jax(jcfg)),
        config={**cfg, "train_micro_batch_size_per_gpu": 8}, device="cpu",
        generator=torch.Generator().manual_seed(7))
    teng.load_checkpoint(d)
    loss = teng.forward(batches[2])
    teng.backward(loss)
    teng.step()
    np.testing.assert_allclose(float(loss), want_loss, rtol=FN_TOL,
                               atol=FN_TOL)
    got = convert.to_numpy_params(teng.state["master"])
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=FN_TOL, atol=FN_TOL,
                                   err_msg=jax.tree_util.keystr(path))
