"""The port's BERT (plain path, CPU, fp32) against the JAX package's
``models/bert.py`` on the same params (``convert.from_jax_params``) and
the same seeded numpy MLM batch: hidden states, MLM logits and the loss
with ``seq_lens`` (the flash path, per-row key lengths), with a hole
``attention_mask`` (the dense masked path) and with an all-ones mask
(which takes the flash path); the pooler, ``flops_per_token`` exactly,
and the loss's gradient for every leaf with remat on and off.
Tolerances: hidden states and logits 1e-4, loss and gradients 1e-5
(relative and absolute)."""

import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import mlm_batch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch.models import bert, convert

#: the module (``ops.kernels`` exports a function of the same name)
port_flash = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.flash_attention")

JCFG = jbert.BertConfig(vocab_size=256, max_seq_len=64, type_vocab_size=2,
                        n_layer=2, n_head=4, d_model=64, dtype=jnp.float32,
                        vocab_round_to=128)
CFG = convert.bert_config_from_jax(JCFG)
LOGIT_TOL = 1e-4
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    params = jax.device_get(jbert.init(JCFG, jax.random.PRNGKey(3)))
    batch = mlm_batch(4, 32, JCFG.vocab_size, np.random.default_rng(1),
                      short_prob=0.5)
    batch["seq_lens"][0] = 11                      # at least one short row
    return params, batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _hole_mask(batch):
    """A mask with holes (not right padding): every third live position of
    row 1 masked out as well."""
    S = batch["tokens"].shape[1]
    mask = (np.arange(S)[None, :] < batch["seq_lens"][:, None]).astype(np.int32)
    mask[1, ::3] = 0
    return mask


@pytest.mark.parametrize("mode", ["seq_lens", "hole_mask", "ones_mask"])
def test_encode_logits_loss_match_jax(setup, mode, monkeypatch):
    params, batch = setup
    batch = dict(batch)
    if mode != "seq_lens":
        batch["attention_mask"] = _hole_mask(batch) if mode == "hole_mask" \
            else np.ones_like(batch["tokens"])
        batch.pop("seq_lens")
    flash_calls = []
    real = port_flash._forward
    monkeypatch.setattr(port_flash, "_forward",
                        lambda *a: flash_calls.append(1) or real(*a))
    tparams = convert.from_jax_params(params)
    jb, pb = _jax_batch(batch), _port_batch(batch)
    jh = jbert.encode(params, jb["tokens"], JCFG, jb["token_type_ids"],
                      jb.get("attention_mask"), seq_lens=jb.get("seq_lens"))
    ph = bert.encode(tparams, pb["tokens"], CFG, pb["token_type_ids"],
                     pb.get("attention_mask"), seq_lens=pb.get("seq_lens"))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(bert.mlm_logits(tparams, ph, CFG).numpy(),
                               np.asarray(jbert.mlm_logits(params, jh, JCFG)),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(bert.loss_fn(tparams, pb, CFG)),
                               float(jbert.loss_fn(params, jb, JCFG)),
                               rtol=TOL, atol=TOL)
    # the flash op ran for every layer, except under a mask with holes
    assert len(flash_calls) == (0 if mode == "hole_mask" else 2 * CFG.n_layer)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match_jax(setup, remat):
    params, batch = setup
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbert.loss_fn(p, _jax_batch(batch), JCFG))(params)
    tparams = convert.from_jax_params(params)
    leaves = jax.tree_util.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    cfg = dataclasses.replace(CFG, remat=remat)
    loss = bert.loss_fn(tparams, _port_batch(batch), cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    grads = convert.to_numpy_params(
        jax.tree_util.tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                               else p.grad, tparams))
    want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads)))
    got = jax.tree_util.tree_leaves_with_path(grads)
    assert len(got) == len(want) == 24
    for path, g in got:
        np.testing.assert_allclose(g, want[path], rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_pooler_and_flops_match_jax(setup):
    params, batch = setup
    jb = _jax_batch(batch)
    jh = jbert.encode(params, jb["tokens"], JCFG, seq_lens=jb["seq_lens"])
    tparams = convert.from_jax_params(params)
    ph = bert.encode(tparams, torch.from_numpy(batch["tokens"]).long(), CFG,
                     seq_lens=torch.from_numpy(batch["seq_lens"]))
    np.testing.assert_allclose(bert.pooled_output(tparams, ph, CFG).numpy(),
                               np.asarray(jbert.pooled_output(params, jh, JCFG)),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for jcfg in (JCFG, jbert.BERT_BASE,
                 dataclasses.replace(jbert.BERT_LARGE, max_seq_len=128)):
        assert bert.flops_per_token(convert.bert_config_from_jax(jcfg)) == \
            jbert.flops_per_token(jcfg)


def test_init_tree_matches_jax_layout():
    """The port's init has the JAX tree, shapes and fp32 leaves, with the
    JAX init's constant leaves (LayerNorm 1/0, biases 0)."""
    jtree = jax.eval_shape(lambda: jbert.init(JCFG, jax.random.PRNGKey(0)))
    ptree = bert.init(CFG, torch.Generator().manual_seed(0))
    want = dict(jax.tree_util.tree_leaves_with_path(jtree))
    got = jax.tree_util.tree_leaves_with_path(ptree)
    assert len(got) == len(want)
    for path, t in got:
        assert tuple(t.shape) == want[path].shape, path
        assert t.dtype == torch.float32
    assert torch.equal(ptree["blocks"]["ln1_scale"],
                       torch.ones_like(ptree["blocks"]["ln1_scale"]))
    assert not ptree["pool_b"].any() and not ptree["mlm_bias"].any()


def test_unported_options_raise():
    for field in ("dropout", "attn_dropout"):
        with pytest.raises(NotImplementedError, match=field):
            bert.BertConfig(**{field: 0.1})
        with pytest.raises(NotImplementedError, match=field):
            convert.bert_config_from_jax(
                dataclasses.replace(JCFG, **{field: 0.1}))
    with pytest.raises(NotImplementedError, match="dropout"):
        bert.loss_fn(bert.init(CFG), {"tokens": torch.zeros(1, 4).long(),
                                      "mlm_labels": torch.zeros(1, 4).long(),
                                      "_train_rng": None}, CFG)
