"""Sharded checkpoints: a rank's blocks saved as global arrays, restored
onto any mesh.

qwen3-0.6b-smoke's "tp_fsdp" train state (parameters and AdamW state,
f32) after one step on a (2, 2) mesh of 4 gloo ranks is saved with its
specs (``CheckpointManager.save(..., spec_tree=, mesh=)``: each leaf's
distinct blocks sent to the first rank, which writes the global arrays
in the reference's format). Then, in the same ranks:

- restored on (2, 2), (1, 4) and (4, 1) into a state of other values,
  each rank's blocks equal ``shard_tree`` of the saved state bit for bit,
  and the next step from them equals the next step from ``shard_tree``
  of the in-memory state on that mesh; on (2, 2) it is the unsaved
  run's own next step, bit for bit (loss, parameters, AdamW state);

and in this process: on a (1, 1) mesh of one gloo rank the restored
state is the saved one and its next step is the unsharded step's, bit
for bit; the reference's ``repro.checkpoint.CheckpointManager`` restores
the same files whole, equal to ``gather_tree`` of the blocks; and a
save without specs writes what it is given, as before.
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tT
from repro_torch.train.optimizer import AdamW
from repro_torch.train.steps import make_lm_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tp_workers as W  # noqa: E402

ARCH, BATCH, SEQ = "qwen3-0.6b", 4, 24


def inputs():
    """(port config, numpy params from a seeded init, two numpy
    batches)."""
    cfg = get_arch(ARCH).smoke
    assert cfg.parallelism == "tp_fsdp"
    params = tree_map(lambda v: v.numpy(), tT.init_params(
        cfg, torch.Generator().manual_seed(2), "cpu"))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1))
        batches.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return cfg, params, batches


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(the checkpoint directory, rank results of ``ckpt_worker``)."""
    cfg, params, batches = inputs()
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    res = run_ranks(W.jobs, 4, [("ckpt_worker", (cfg, params, batches,
                                                 ckpt))],
                    backend="gloo",
                    store_dir=str(tmp_path_factory.mktemp("ckpt_pg")),
                    timeout_s=180.0)
    return ckpt, [r[0] for r in res]


def _state_like(cfg, params):
    """{"params", "opt_state"} of the port (whole tensors)."""
    p = tree_from_numpy(params, "cpu")
    return {"params": p, "opt_state": AdamW(lr=1e-3,
                                            weight_decay=0.01).init(p)}


@pytest.mark.parametrize("shape", W.CKPT_MESHES,
                         ids=[f"{a}x{b}" for a, b in W.CKPT_MESHES])
def test_restores_bitwise_on_every_mesh(shape, saved):
    _, res = saved
    for r in res:
        m = r["meshes"][shape]
        assert m["restored_equal"] and m["next_equal"]


def test_next_step_after_restore_is_the_unsaved_runs(saved):
    _, res = saved
    r = res[0]
    got = r["meshes"][(2, 2)]
    assert got["loss"] == r["unsaved_loss"]
    assert len(got["next"]) == len(r["unsaved_next"])
    for a, b in zip(got["next"], r["unsaved_next"]):
        np.testing.assert_array_equal(a, b)


def test_every_rank_saw_the_same_global_state(saved):
    _, res = saved
    for r in res[1:]:
        for a, b in zip(r["saved"], res[0]["saved"]):
            np.testing.assert_array_equal(a, b)


def test_reference_manager_restores_whole(saved):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.train.optimizer import AdamW as RefAdamW

    ckpt, res = saved
    _, params, _ = inputs()
    p = jax.tree.map(jnp.asarray, params)
    like = {"params": p, "opt_state": RefAdamW(lr=1e-3).init(p)}
    restored, manifest = RefManager(ckpt, async_save=False).restore(1, like)
    leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == len(res[0]["saved"]) == len(manifest["keys"])
    for a, b in zip(leaves, res[0]["saved"]):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("ckpt1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_restores_on_one_rank_and_steps_as_unsharded(saved, one_rank):
    ckpt, res = saved
    cfg, params, batches = inputs()
    zero = _state_like(cfg, tree_map(np.zeros_like, params))
    specs = tshd.lm_param_specs(cfg, one_rank, zero["params"])
    spec_tree = {"params": specs, "opt_state": tshd.opt_state_specs(specs)}
    restored, _ = CheckpointManager(ckpt, async_save=False).restore(
        1, zero, spec_tree=spec_tree, mesh=one_rank)
    leaves = tree_leaves(restored)
    for a, b in zip(leaves, res[0]["saved"]):
        np.testing.assert_array_equal(a.numpy(), b)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    sharded = make_lm_train_step(cfg, opt, act_constraint=W.residual(
        one_rank, cfg), **W.LM_KW)
    plain = make_lm_train_step(cfg, opt, **W.LM_KW)
    batch = {k: torch.from_numpy(v) for k, v in batches[1].items()}
    want = tree_unflatten(restored, [torch.from_numpy(b.copy())
                                     for b in res[0]["saved"]])
    got = sharded(restored["params"], restored["opt_state"], batch)
    ref = plain(want["params"], want["opt_state"], batch)
    assert torch.equal(got[2]["loss"], ref[2]["loss"])
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(ref[:2])):
        assert torch.equal(a, b)


def test_save_without_specs_writes_the_tree_as_given(tmp_path, one_rank):
    """No specs: the leaves as they are (a rank's blocks stay blocks)."""
    x = {"w": torch.arange(6.0).reshape(2, 3)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, x)
    got, _ = mgr.restore(3, {"w": torch.zeros(2, 3)})
    assert torch.equal(got["w"], x["w"])


def test_sharded_save_of_a_split_leaf_on_one_rank(tmp_path, one_rank):
    """Specs over axes of one rank: the block is the leaf."""
    x = {"w": torch.arange(8.0).reshape(4, 2)}
    specs = {"w": tshd.P("data", "model")}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, x, spec_tree=specs, mesh=one_rank)
    mgr.wait()
    assert mgr.latest_step() == 1
    got, _ = mgr.restore(1, {"w": torch.zeros(4, 2)}, spec_tree=specs,
                         mesh=one_rank)
    assert torch.equal(got["w"], x["w"])
