"""The port's ``module_inject/load_checkpoint.py`` against the JAX
package's: ``load_sharded_state_dict`` over an index with ``.bin``
shards, an index beside a ``safetensors`` one (which wins), weight files
without an index among Trainer files, ``.npz`` and ``.safetensors``
shards, and its two errors, each read by both packages into the same
arrays bitwise; an HF-keyed BERT state dict loaded from shards converts
to the same tree as the dict itself; ``module_quantize`` on a tiny BERT
tree bitwise equal to JAX's."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.module_inject import load_checkpoint as jload
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.module_inject import (HFBertLayerPolicy,
                                               load_sharded_state_dict,
                                               module_quantize)


def _state_dict(n=7, seed=0):
    rng = np.random.default_rng(seed)
    return {f"layer.{i}.weight": rng.standard_normal((4, 3 + i))
            .astype(np.float32) for i in range(n)}


def _write(root, sd, kind, n_shards=3, index=True):
    """``sd`` as ``n_shards`` shards of ``kind`` ("bin", "npz",
    "safetensors") under ``root``, with an HF index json or without."""
    keys = sorted(sd)
    ext = {"bin": "bin", "npz": "npz", "safetensors": "safetensors"}[kind]
    stem = "model" if kind == "safetensors" else "pytorch_model"
    weight_map = {}
    for i in range(n_shards):
        name = f"{stem}-{i + 1:05d}-of-{n_shards:05d}.{ext}"
        part = {k: sd[k] for k in keys[i::n_shards]}
        path = os.path.join(root, name)
        if kind == "bin":
            torch.save({k: torch.from_numpy(v) for k, v in part.items()},
                       path)
        elif kind == "npz":
            np.savez(path, **part)
        else:
            from safetensors.numpy import save_file
            save_file(part, path)
        weight_map.update({k: name for k in part})
    if index:
        index_name = f"{stem}.{ext}.index.json"
        with open(os.path.join(root, index_name), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


@pytest.mark.parametrize("kind,index", [("bin", True), ("bin", False),
                                        ("npz", True), ("npz", False),
                                        ("safetensors", True)])
def test_shards_load_as_the_jax_loader_does(tmp_path, kind, index):
    if kind == "safetensors":
        pytest.importorskip("safetensors")
    sd = _state_dict()
    _write(str(tmp_path), sd, kind, index=index)
    if not index:
        # HF Trainer files beside the weights: none is a state dict
        torch.save([1, 2], str(tmp_path / "optimizer.pt"))
        torch.save([3], str(tmp_path / "training_args.bin"))
    got = load_sharded_state_dict(str(tmp_path))
    _assert_same(got, sd)
    _assert_same(got, jload.load_sharded_state_dict(str(tmp_path)))
    if kind == "bin":
        assert all(isinstance(v, torch.Tensor) for v in got.values())


def test_a_safetensors_index_is_chosen_first(tmp_path):
    pytest.importorskip("safetensors")
    _write(str(tmp_path), _state_dict(seed=1), "bin")
    want = _state_dict(seed=2)
    _write(str(tmp_path), want, "safetensors", n_shards=2)
    _assert_same(load_sharded_state_dict(str(tmp_path)), want)


def test_the_two_errors_match_the_jax_loader(tmp_path):
    for loader in (load_sharded_state_dict, jload.load_sharded_state_dict):
        with pytest.raises(FileNotFoundError, match="no checkpoint shards"):
            loader(str(tmp_path))
    torch.save([torch.zeros(2)], str(tmp_path / "pytorch_model.bin"))
    errors = []
    for loader in (load_sharded_state_dict, jload.load_sharded_state_dict):
        with pytest.raises(ValueError) as err:
            loader(str(tmp_path))
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "pytorch_model.bin is not a state " \
        "dict (list)"


def test_sharded_hf_bert_converts_to_the_same_tree(tmp_path):
    """An HF-keyed BERT state dict, saved as 3 ``.bin`` shards with an
    index and loaded back, converts bitwise to the tree of the dict
    itself."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=100, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertForMaskedLM(cfg).eval()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    _write(str(tmp_path), sd, "bin")
    loaded = load_sharded_state_dict(str(tmp_path))
    bcfg = HFBertLayerPolicy.model_config(cfg)
    want = convert.to_numpy_params(HFBertLayerPolicy.convert(sd, bcfg))
    got = convert.to_numpy_params(HFBertLayerPolicy.convert(loaded, bcfg))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    for path, w in leaves:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))


JCFG = jbert.BertConfig(vocab_size=256, max_seq_len=64, n_layer=2, n_head=4,
                        d_model=64, dtype=jnp.float32)


def test_module_quantize_matches_jax():
    """Two groups a layer: every leaf bitwise equal to JAX's (both divide
    by the step, eagerly), the stacked ones on the int8 grid of their
    groups, biases and norms passed through."""
    params = jax.device_get(jbert.init(JCFG, jax.random.PRNGKey(1)))
    want = jax.device_get(jload.module_quantize(params, groups_per_layer=2))
    got = convert.to_numpy_params(module_quantize(
        convert.from_jax_params(params), groups_per_layer=2))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        name = jax.tree_util.keystr(path)
        g, src = got, params
        for key in path:
            g, src = g[key.key], src[key.key]
        np.testing.assert_array_equal(g, w, err_msg=name)
        if src.ndim >= 3:
            rows = g.reshape(src.shape[0] * 2, -1)
            assert max(np.unique(r).size for r in rows) <= 255, name
            assert not np.any(src) or not np.array_equal(g, src), name
