"""The port's checkpoints (``DeepSpeedEngine.save_checkpoint`` /
``load_checkpoint``) against the JAX package's, on TINY_GPT and the tiny
BERT of ``test_torch_bert_training.py``.

- A tag the JAX engine (8-device CPU mesh, micro 1 × dp 8) saves after 2
  of 4 steps resumes in a port engine (micro 8, built from another seed),
  and a tag the port saves resumes in a JAX engine: both continue the JAX
  engine's straight 4-step trajectory, losses and final master params at
  ``test_torch_training.py``'s 1e-5, counters, the optimizer's step and the
  loss scale exactly.  The JAX package's ``verify_tag`` and
  ``zero_to_fp32`` accept the port's tag.
- Both packages write the same files, npz keys, shapes and dtypes, and
  JSON keys, in fp32 (with and without a separate master), bf16 and fp16.
- Port → port resume is bitwise equal to the straight run: every flat
  buffer, the optimizer's moments and step, the loss scale, the counters
  and the LR schedule, in each case of ``BITWISE``."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from chip_smoke import mlm_batch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.runtime.checkpoint_engine import verify_tag as jax_verify_tag
from deepspeed_tpu.utils.zero_to_fp32 import (
    get_fp32_state_dict_from_zero_checkpoint as jax_zero_to_fp32)
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.checkpoint_engine import verify_tag
from deepspeed_tpu_torch.runtime.model import from_bert, from_gpt
from deepspeed_tpu_torch.utils import fault_injection, zero_to_fp32
from tests.unit.common import (TINY_GPT, base_config, make_mesh,
                               random_tokens, tiny_model)

TOL = 1e-5
SEQ = 16
STEPS = 4
#: the step after which a run saves
SAVE_AT = 2
OPTIMIZER = {"optimizer": {"type": "Adam",
                           "params": {"lr": 1e-4, "weight_decay": 0.01}}}
#: the cross-package cases (fp32): name -> ZeRO stage; stage 0 keeps no
#: separate master, stage 1 does
CROSS = {"stage0": 0, "stage1": 1}


def _batches(n=STEPS, seed=1):
    return [random_tokens(8, SEQ, seed=seed + i) for i in range(n)]


def _config(micro_batch, stage, extra=None, **precision):
    return base_config(micro_batch=micro_batch, gas=1, stage=stage,
                       extra={**OPTIMIZER, **(extra or {})}, **precision)


def _jax_engine(stage, seed=42, dtype=jnp.float32, **precision):
    engine, *_ = deepspeed_tpu.initialize(
        model=tiny_model(dtype=dtype), config=_config(1, stage, **precision),
        mesh_manager=make_mesh(dp=8), rng=jax.random.PRNGKey(seed))
    return engine


def _port_engine(stage, master_np=None, seed=7, dtype=torch.float32,
                 **precision):
    spec = from_gpt(convert.config_from_jax(TINY_GPT, dtype=dtype))
    if master_np is not None:
        spec = dataclasses.replace(
            spec, params=convert.from_jax_params(master_np))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config=_config(8, stage, **precision), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    return engine


def _step(engine, batch):
    loss = engine.forward(batch)
    engine.backward(loss)
    engine.step()
    return float(loss)


def _counters(engine):
    return (engine.micro_steps, engine.global_steps, engine.global_samples,
            engine.skipped_steps)


def _jax_scale(engine):
    return {k: np.asarray(v) for k, v in
            jax.device_get(engine.state["scale"]).items()}


def _port_scale(engine):
    return {k: v.cpu().numpy() for k, v in engine.state["scale"].items()}


def _assert_tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per cross case: the JAX engine's 4 straight steps, saving after
    step 2 (a save does not move the state): its initial master, losses,
    final master, counters, optimizer step and scale, and the tag."""
    out = {}
    for name, stage in CROSS.items():
        d = str(tmp_path_factory.mktemp(f"jax_{name}"))
        engine = _jax_engine(stage)
        init = jax.device_get(engine.state["master"])
        losses = []
        for i, b in enumerate(_batches()):
            if i == SAVE_AT:
                engine.save_checkpoint(d)
            losses.append(_step(engine, b))
        out[name] = dict(
            dir=d, init=init, losses=losses,
            master=jax.device_get(engine.state["master"]),
            counters=_counters(engine), scale=_jax_scale(engine),
            opt_step=int(engine.state["opt_state"]["step"]))
    return out


def _assert_continues(ref, losses, master, counters, scale, opt_step):
    np.testing.assert_allclose(losses, ref["losses"][SAVE_AT:], rtol=TOL,
                               atol=TOL)
    _assert_tree_close(master, ref["master"], TOL)
    assert counters == ref["counters"] and opt_step == ref["opt_step"]
    assert scale.keys() == ref["scale"].keys()
    for k in scale:
        assert scale[k].dtype == ref["scale"][k].dtype
        np.testing.assert_array_equal(scale[k], ref["scale"][k])


@pytest.mark.parametrize("case", list(CROSS))
def test_jax_tag_resumes_in_port(jax_runs, case):
    ref = jax_runs[case]
    engine = _port_engine(CROSS[case], seed=7)
    assert verify_tag(ref["dir"], f"global_step{SAVE_AT}") == (True, [])
    load_dir, client = engine.load_checkpoint(ref["dir"])
    assert load_dir == ref["dir"] and client["global_steps"] == SAVE_AT
    losses = [_step(engine, b) for b in _batches()[SAVE_AT:]]
    _assert_continues(ref, losses,
                      convert.to_numpy_params(engine.state["master"]),
                      _counters(engine), _port_scale(engine),
                      engine.state["opt_state"]["step"])


@pytest.mark.parametrize("case", list(CROSS))
def test_port_tag_resumes_in_jax(jax_runs, case, tmp_path):
    ref = jax_runs[case]
    port = _port_engine(CROSS[case], master_np=ref["init"])
    for b in _batches()[:SAVE_AT]:
        _step(port, b)
    d = str(tmp_path)
    assert port.save_checkpoint(d)
    tag = f"global_step{SAVE_AT}"
    assert jax_verify_tag(d, tag) == (True, [])
    # the JAX package's recovery and the port's read the port's master
    recovered = jax_zero_to_fp32(d)
    ours = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(d)
    flat = {"/".join(p): t for p, t in _flat_paths(port.state["master"])}
    assert recovered.keys() == ours.keys() == flat.keys()
    for k, v in recovered.items():
        np.testing.assert_array_equal(v, flat[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(ours[k], v, err_msg=k)

    engine = _jax_engine(CROSS[case], seed=7)
    engine.load_checkpoint(d)
    losses = [_step(engine, b) for b in _batches()[SAVE_AT:]]
    _assert_continues(ref, losses, jax.device_get(engine.state["master"]),
                      _counters(engine), _jax_scale(engine),
                      int(engine.state["opt_state"]["step"]))


def _flat_paths(tree, prefix=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_flat_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


#: name -> (stage, jax dtype, port dtype, precision section)
LAYOUT = {"fp32_stage0": (0, jnp.float32, torch.float32, {}),
          "fp32_stage1": (1, jnp.float32, torch.float32, {}),
          "bf16_stage1": (1, jnp.bfloat16, torch.bfloat16,
                          {"bf16": {"enabled": True}}),
          "fp16_stage0": (0, jnp.float16, torch.float16,
                          {"fp16": {"enabled": True}})}


def _layout(d):
    """Files under the root and the tag, npz key -> (shape, dtype), and the
    JSON files' key sets."""
    tag = open(os.path.join(d, "latest")).read().strip()
    t = os.path.join(d, tag)
    out = {"root": sorted(os.listdir(d)), "tag": sorted(os.listdir(t))}
    for f in ("model_states.npz", "optim_states.npz"):
        with np.load(os.path.join(t, f)) as z:
            out[f] = {k: (z[k].shape, z[k].dtype) for k in z.files}
    for f in ("manifest.json", "commit.json", "client_state.json",
              "rank0.ready"):
        with open(os.path.join(t, f)) as fh:
            doc = json.load(fh)
        out[f] = sorted(doc)
        if "files" in doc:
            out[f + " files"] = sorted(doc["files"])
        if "optimizer_param_groups" in doc:
            out[f + " groups"] = [sorted(g)
                                  for g in doc["optimizer_param_groups"]]
    return out


@pytest.mark.parametrize("case", list(LAYOUT))
def test_both_packages_write_one_layout(case, tmp_path):
    stage, jdtype, pdtype, precision = LAYOUT[case]
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jengine = _jax_engine(stage, dtype=jdtype, **precision)
    port = _port_engine(stage, dtype=pdtype, **precision)
    batch = _batches(1)[0]
    _step(jengine, batch)
    _step(port, batch)
    jengine.save_checkpoint(jd)
    port.save_checkpoint(pd)
    want, got = _layout(jd), _layout(pd)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert ("master/wte" in got["optim_states.npz"]) == (case != "fp32_stage0")
    with open(os.path.join(pd, "zero_to_fp32.py")) as f:
        assert "from deepspeed_tpu_torch.utils.zero_to_fp32 import main" in \
            f.read()


# ---------------------------------------------------------- port -> port

BERT = jbert.BertConfig(vocab_size=256, max_seq_len=32, type_vocab_size=2,
                        n_layer=2, n_head=4, d_model=64, dtype=jnp.float32,
                        vocab_round_to=128)
LAMB = {"optimizer": {"type": "Lamb", "params": {
            "lr": 1e-4, "weight_decay": 0.01, "bias_correction": False,
            "max_coeff": 0.3, "min_coeff": 0.01}},
        "gradient_clipping": 1.0}
WARMUP = {"scheduler": {"type": "WarmupLR", "params": {
    "warmup_num_steps": 6, "warmup_max_lr": 1e-3,
    "warmup_type": "linear"}}}

#: name -> what differs from GPT, stage 1, fp32, gas 1, forward/backward/
#: step: ``micro_steps`` in all, the micro-step after which it saves, and
#: the config
BITWISE = {
    "stage0_fp32": dict(stage=0),
    "stage1_bf16": dict(dtype=torch.bfloat16,
                        extra={"bf16": {"enabled": True}}),
    # an inf in the accumulator at the first step: skipped, the scale
    # halves (hysteresis 1); a window of 2 then grows it after the resume
    "fp16_overflow": dict(stage=0, dtype=torch.float16, overflow_at=0,
                          extra={"fp16": {"enabled": True, "hysteresis": 1,
                                          "loss_scale_window": 2}}),
    "gas2_midwindow": dict(stage=0, gas=2, micro_steps=6, save_after=3),
    "fused": dict(fused=True),
    "warmup_lr": dict(extra=WARMUP),
    "bert_lamb": dict(bert=True, extra=LAMB),
    "async_then_step": dict(extra={"checkpoint": {"async_save": True}},
                            step_after_save=True),
}


def _bitwise_engine(case, seed):
    c = BITWISE[case]
    dtype = c.get("dtype", torch.float32)
    if c.get("bert"):
        spec = from_bert(convert.bert_config_from_jax(BERT, dtype=dtype))
    else:
        spec = from_gpt(convert.config_from_jax(TINY_GPT, dtype=dtype))
    config = base_config(micro_batch=4, gas=c.get("gas", 1),
                         stage=c.get("stage", 1),
                         extra={**OPTIMIZER, **c.get("extra", {})})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config=config, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    return engine


def _bitwise_batches(case):
    c = BITWISE[case]
    n = c.get("micro_steps", STEPS)
    if c.get("bert"):
        return [mlm_batch(4, BERT.max_seq_len, BERT.vocab_size,
                          np.random.default_rng(3 + i), short_prob=0.25)
                for i in range(n)]
    return [random_tokens(4, SEQ, seed=3 + i) for i in range(n)]


def _micro(engine, case, i, batch):
    """Micro-step ``i`` (a whole step under ``train_batch_fused``)."""
    c = BITWISE[case]
    if c.get("fused"):
        return engine.train_batch_fused(batch)
    loss = engine.forward(batch)
    engine.backward(loss)
    if c.get("overflow_at") == i:
        engine._flat["grad_acc"][0] = float("inf")
    engine.step()
    return loss


def _assert_bitwise(got, want):
    for k, buf in want._flat.items():
        assert torch.equal(got._flat[k], buf), k
    for k, v in want.state["opt_state"].items():
        w = got.state["opt_state"][k]
        assert torch.equal(w, v) if torch.is_tensor(v) else w == v, k
    for k, v in want.state["scale"].items():
        assert torch.equal(got.state["scale"][k], v), k
    assert _counters(got) == _counters(want)
    assert got.get_lr() == want.get_lr()
    if want.lr_scheduler is not None:
        assert got.lr_scheduler.state_dict() == want.lr_scheduler.state_dict()


@pytest.mark.parametrize("case", list(BITWISE))
def test_port_resume_is_bitwise(case, tmp_path):
    """k micro-steps, save, load into an engine built from another seed,
    the rest: bitwise the straight run.  Right after the load the loaded
    engine's loss is bitwise the saver's (the load went into the buffers
    the autograd leaves view), and an async save followed at once by a
    step holds the state at save time."""
    c = BITWISE[case]
    batches = _bitwise_batches(case)
    k = c.get("save_after", SAVE_AT)
    straight = _bitwise_engine(case, seed=1)
    losses = [_micro(straight, case, i, b) for i, b in enumerate(batches)]
    if "overflow_at" in c:
        assert straight.skipped_steps == 1
        assert straight.state["opt_state"]["step"] == len(batches) - 1

    saver = _bitwise_engine(case, seed=1)
    for i, b in enumerate(batches[:k]):
        _micro(saver, case, i, b)
    probe = batches[k]
    before = saver.eval_loss(probe)
    if c.get("step_after_save"):
        # the writers start late, so the step lands before they read
        with fault_injection.inject("ckpt.write",
                                    fault_injection.DelaySeconds(0.3, n=1)):
            saver.save_checkpoint(str(tmp_path))
            _micro(saver, case, k, probe)      # in place
            saver._checkpoint_engine.wait()
    else:
        saver.save_checkpoint(str(tmp_path))

    resumed = _bitwise_engine(case, seed=2)
    assert not torch.equal(resumed._flat["master"], saver._flat["master"])
    resumed.load_checkpoint(str(tmp_path))
    assert torch.equal(resumed.eval_loss(probe), before)
    tail = [_micro(resumed, case, i, b)
            for i, b in enumerate(batches[k:], start=k)]
    assert all(torch.equal(a, b) for a, b in zip(tail, losses[k:]))
    _assert_bitwise(resumed, straight)


def test_load_module_only_keeps_optimizer_state(tmp_path):
    """``load_module_only``: the params (and, without a separate master,
    the master) come from the tag; the moments, step, accumulator and
    counters' optimizer side stay the engine's, as in the JAX package."""
    saver = _port_engine(0, seed=1)
    for b in _batches(2):
        _step(saver, b)
    saver.save_checkpoint(str(tmp_path))
    engine = _port_engine(0, seed=2)
    moments = engine.state["opt_state"]["exp_avg"].clone()
    engine.load_checkpoint(str(tmp_path), load_module_only=True)
    assert torch.equal(engine._flat["params"], saver._flat["params"])
    assert torch.equal(engine.state["opt_state"]["exp_avg"], moments)
    assert engine.state["opt_state"]["step"] == 0
    assert engine.global_steps == saver.global_steps


def test_zero_to_fp32_cli_and_shim(tmp_path):
    """The port's recovery CLI and the shim beside the tags write one fp32
    npz of the master; bf16 params without a separate master would be
    widened (here the master is separate)."""
    port = _port_engine(1, seed=1, dtype=torch.bfloat16,
                        bf16={"enabled": True})
    _step(port, _batches(1)[0])
    port.save_checkpoint(str(tmp_path / "ck"))
    out = str(tmp_path / "fp32.npz")
    assert zero_to_fp32.main([str(tmp_path / "ck"), out]) == 0
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    flat = {"/".join(p): t for p, t in _flat_paths(port.state["master"])}
    assert got.keys() == flat.keys()
    for k, v in got.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, flat[k].numpy(), err_msg=k)
    assert zero_to_fp32.main([]) == 1


def test_save_defaults_and_latest(tmp_path):
    """Tags default to ``global_step<N>``; ``save_latest=False`` leaves
    the marker; a load with no tag anywhere loads nothing."""
    engine = _port_engine(1)
    assert engine.load_checkpoint(str(tmp_path)) == (None, {})
    _step(engine, _batches(1)[0])
    engine.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    engine.save_checkpoint(str(tmp_path), tag="side", save_latest=False)
    assert open(tmp_path / "latest").read() == "global_step1"
    assert sorted(os.listdir(tmp_path)) == ["global_step1", "latest", "side",
                                            "zero_to_fp32.py"]
    _, client = _port_engine(1, seed=3).load_checkpoint(str(tmp_path))
    assert client["epoch"] == 3 and client["global_steps"] == 1
