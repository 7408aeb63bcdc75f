"""The port's checkpoints and fault-tolerant runner against the reference.

``repro_torch.checkpoint.CheckpointManager`` writes the reference's
layout (``arrays.npz`` + ``manifest.json`` + ``COMMITTED``, a CRC32 per
leaf) under the reference's leaf keys (JAX keypaths such as
``['w']/[0]``), so a checkpoint crosses between the two packages in both
directions, bit for bit. ``TrainingRunner`` resumes deterministically and
rolls back on a NaN loss, as the reference's does.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.train.optimizer import AdamW as JaxAdamW
from repro_torch.checkpoint import (COMMIT_MARKER, CheckpointManager,
                                    ChecksumError)
from repro_torch.convert import tree_from_numpy
from repro_torch.distributed.fault_tolerance import (RunnerConfig,
                                                     SimulatedFailure,
                                                     TrainingRunner)
from repro_torch.train.optimizer import SGD, AdamW
from repro_torch.train.steps import value_and_grad
from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

torch.set_num_threads(2)


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": [rng.standard_normal((5, 3)).astype(np.float32),
                  rng.standard_normal((3, 2)).astype(np.float32)],
            "layers": [{"A": rng.standard_normal((2, 2)).astype(np.float32),
                        "ln": rng.standard_normal(2).astype(np.float32)}],
            "mlp": [(rng.standard_normal((2, 2)).astype(np.float32),
                     np.zeros(2, np.float32))]}


def _state(params_np):
    """(reference state tree, port state tree) of the same numbers: the
    params, an AdamW state after one update, and the step."""
    jp = jax.tree.map(jnp.asarray, params_np)
    opt = JaxAdamW(lr=1e-2)
    grads = jax.tree.map(lambda p: p * 0.5 + 1.0, jp)
    jp2, js = opt.update(grads, opt.init(jp), jp)
    ref = {"params": jp2, "opt_state": js, "step": np.asarray(3, np.int32)}
    port = {"params": tree_from_numpy(jax.tree.map(np.asarray, jp2), "cpu"),
            "opt_state": tree_from_numpy(jax.tree.map(np.asarray, js), "cpu"),
            "step": np.asarray(3, np.int32)}
    return ref, port


def _leaves_equal(a_tree, b_tree):
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(a_tree)]
    b = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
         for x in tree_leaves(b_tree)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_leaf_keys_are_the_references():
    from repro.checkpoint.checkpoint import _flatten
    ref, port = _state(_numpy_tree())
    assert [k for k, _ in flatten_with_path(port)] == _flatten(ref)[0]


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref, port = _state(_numpy_tree())
    JaxManager(str(tmp_path), async_save=False).save(4, ref)
    restored, man = CheckpointManager(str(tmp_path)).restore_latest(port)
    assert man["step"] == 4
    assert isinstance(restored["opt_state"], type(port["opt_state"]))
    _leaves_equal(ref, restored)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    ref, port = _state(_numpy_tree(1))
    mgr = CheckpointManager(str(tmp_path))          # async writer
    mgr.save(6, port)
    mgr.wait()
    restored, man = JaxManager(str(tmp_path)).restore_latest(ref)
    assert man["step"] == 6
    _leaves_equal(restored, port)


def test_roundtrip_keeps_device_dtype_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "nest": {"b": torch.ones((3, 2), dtype=torch.float64)},
            "i": torch.arange(3, dtype=torch.int32)}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree_map(lambda x: x * step, tree))
    assert mgr.all_steps() == [3, 4]
    restored, _ = mgr.restore_latest(tree)
    for k in ("a", "i"):
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k] * 4)
    assert torch.equal(restored["nest"]["b"], tree["nest"]["b"] * 4)


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError):
        mgr.restore(1, {"y": torch.zeros(3)})
    with pytest.raises(ValueError):
        mgr.restore(1, {"x": torch.zeros(4)})


def test_checksum_detects_silent_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    mgr.save(1, tree)
    mgr.save(2, {"x": tree["x"] * 2})
    npz = os.path.join(tmp_path, "step_2", "arrays.npz")
    data = dict(np.load(npz))
    data["a0"] = data["a0"] + 1.0               # bit-rot, container intact
    np.savez(npz, **data)
    with pytest.raises(ChecksumError):
        mgr.restore(2, tree)
    restored, man = mgr.restore_latest(tree)
    assert man["step"] == 1
    assert torch.equal(restored["x"], tree["x"])
    assert ("checksum_fallback", 2) in mgr.events


def test_uncommitted_step_skipped(tmp_path):
    writer = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"x": torch.arange(3, dtype=torch.float32)}
    writer.save(1, tree)
    reader = CheckpointManager(str(tmp_path), async_save=False)
    writer.save(2, {"x": tree["x"] * 2})
    os.remove(os.path.join(tmp_path, "step_2", COMMIT_MARKER))
    os.makedirs(os.path.join(tmp_path, ".tmp-step_3"))    # crashed write
    assert reader.all_steps() == [1]
    restored, man = reader.restore_latest(tree)
    assert man["step"] == 1 and torch.equal(restored["x"], tree["x"])
    with open(os.path.join(tmp_path, "step_1", "manifest.json")) as f:
        assert len(json.load(f)["crc32"]) == 1


# ------------------------------------------------------------- runner ----
def _quad_step(optimizer):
    def loss_fn(p, batch):
        return torch.mean((p["w"] - batch) ** 2)

    def step(params, opt_state, batch):
        loss, g = value_and_grad(loss_fn, params, batch)
        params, opt_state = optimizer.update(g, opt_state, params)
        return params, opt_state, {"loss": loss}
    return step


def _batch_at(i):
    return torch.tensor([float(i % 3)])


@pytest.mark.parametrize("opt", [SGD(lr=0.05, momentum=0.0),
                                 AdamW(lr=0.1)], ids=["sgd", "adamw"])
def test_failure_and_resume_deterministic(tmp_path, opt):
    step = _quad_step(opt)
    p0 = {"w": torch.tensor([10.0])}
    s0 = opt.init(p0)
    rc = RunnerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=4,
                      max_steps=20)
    with pytest.raises(SimulatedFailure):
        TrainingRunner(rc, step, _batch_at, inject_failure_at=10).run(p0, s0)
    r2 = TrainingRunner(rc, step, _batch_at)
    p_resumed, s_resumed, end = r2.run(p0, s0)
    assert end == 20 and ("resume", 8) in r2.events
    rc2 = RunnerConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                       max_steps=20)
    p_clean, s_clean, _ = TrainingRunner(rc2, step, _batch_at).run(p0, s0)
    # one process, one order of operations: the resumed run is bitwise
    assert torch.equal(p_resumed["w"], p_clean["w"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s_resumed),
                                                 tree_leaves(s_clean)))


def test_nan_loss_triggers_rollback(tmp_path):
    opt = SGD(lr=0.05, momentum=0.0)
    step = _quad_step(opt)
    calls = {"n": 0, "fired": False}

    def nan_step(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        if not calls["fired"] and calls["n"] >= 10:
            calls["fired"] = True
            metrics = {"loss": torch.tensor(float("nan"))}
        calls["n"] += 1
        return params, opt_state, metrics

    p0 = {"w": torch.tensor([10.0])}
    rc = RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=4, max_steps=16)
    r = TrainingRunner(rc, nan_step, _batch_at)
    p_end, _, end = r.run(p0, opt.init(p0))
    assert end == 16 and ("rollback", 8) in r.events
    assert torch.isfinite(p_end["w"]).all()


# ------------------------------------------------------------------ LM ----
def test_reference_lm_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains a smoke LM one f32 step and saves its params
    (stacked ``[L, ...]`` layers) and ``AdamWState``; the port restores
    them under the same leaf keys and takes the next step, whose loss
    equals the reference's next loss within ``rtol=1e-4``."""
    import dataclasses

    from repro.configs import get_arch as jax_get_arch
    from repro.models import transformer as jt
    from repro.train.steps import chunked_cross_entropy as jxent
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as tt
    from repro_torch.train import steps as tsteps

    jcfg = dataclasses.replace(jax_get_arch("qwen3-moe-235b-a22b").smoke,
                               capacity_factor=8.0)
    tcfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").smoke,
                               capacity_factor=8.0)
    stream = TokenStream(jcfg.vocab, 2, 16, seed=0)
    kw = dict(q_chunk=8, k_chunk=8)

    def jloss(p, batch):
        h = jt.forward(p, jnp.asarray(batch["tokens"]), jcfg,
                       compute_dtype=None, **kw)
        return jxent(h, p["lm_head"], jnp.asarray(batch["labels"]), chunk=8)

    opt = JaxAdamW(lr=1e-3, weight_decay=0.01)
    grad = jax.jit(jax.value_and_grad(jloss))
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    js = opt.init(jp)
    _, g = grad(jp, stream.batch_at(0))
    jp, js = jax.jit(opt.update)(g, js, jp)
    JaxManager(str(tmp_path), async_save=False).save(
        1, {"params": jp, "opt_state": js, "step": np.asarray(1, np.int32)})
    want, _ = grad(jp, stream.batch_at(1))

    like = {"params": tt.init_params(tcfg, torch.Generator().manual_seed(0),
                                     device="cpu"),
            "step": np.asarray(0, np.int32)}
    like["opt_state"] = AdamW().init(like["params"])
    restored, man = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert man["step"] == 1 and int(restored["step"]) == 1
    _leaves_equal({"params": jp, "opt_state": js,
                   "step": np.asarray(1, np.int32)}, restored)
    step = tsteps.make_lm_train_step(
        tcfg, AdamW(lr=1e-3, weight_decay=0.01), xent_chunk=8,
        compute_dtype=None, **kw)
    _, state, m = step(restored["params"], restored["opt_state"],
                       {k: torch.from_numpy(v)
                        for k, v in stream.batch_at(1).items()})
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-4)
    assert int(state.step) == 2
