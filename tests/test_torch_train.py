"""The port's optimizers and train steps against the reference, and the
paper's pipeline learning on the CPU.

The same numpy trees go through both packages. Optimizer updates are
elementwise float32 (``OPT_TOL``: ``b ** step`` and the square root may
round in the last place differently); a train step also carries the
loss's and gradient's sums (``STEP_TOL``). The train steps are compared
under SGD with momentum, whose update is linear in the gradient: AdamW's
first updates are about ``lr * sign(g)``, so a gradient entry that is 0
up to rounding (a feature column no training node has) moves by ±lr in
either package; AdamW itself is held step for step on given gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import reorder as jax_reorder
from repro.core.hybrid_spmm import gcn_forward as jax_hybrid_gcn
from repro.core.partition import (PartitionConfig as JaxPartitionConfig,
                                  analyze_and_partition as jax_partition)
from repro.data.graphs import make_paper_dataset as jax_dataset
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.examples import quickstart
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
OPT_TOL = dict(rtol=2e-6, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": [rng.standard_normal((4, 3)).astype(np.float32),
                  rng.standard_normal((3,)).astype(np.float32)],
            "m": (rng.standard_normal((2, 2)).astype(np.float32),)}


def _assert_trees_close(port, ref, tol):
    a = [t.detach().cpu().numpy() for t in tree_leaves(port)]
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **tol)


OPTIMIZERS = {
    "adamw": lambda m: m.AdamW(lr=1e-2, weight_decay=0.1, clip_norm=1.0),
    "adamw_schedule": lambda m: m.AdamW(lr=m.warmup_cosine(1e-2, 3, 10)),
    "sgd": lambda m: m.SGD(lr=5e-2, momentum=0.9, clip_norm=0.5),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_step_for_step(name):
    p_np = _tree(0)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = tree_from_numpy(p_np, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(6):
        g_np = _tree(100 + i)
        g_np["w"][0] *= 3.0                      # clipping engages
        jp, js = jo.update(jax.tree.map(jnp.asarray, g_np), js, jp)
        tp, ts = to.update(tree_from_numpy(g_np, "cpu"), ts, tp)
        _assert_trees_close(tp, jp, OPT_TOL)
        _assert_trees_close(ts, js, OPT_TOL)
    assert int(ts.step) == 6 and ts.step.dtype == torch.int32


def test_clip_and_schedule_match_reference():
    g_np = _tree(3)
    for max_norm in (0.1, 1.0, 100.0):
        _assert_trees_close(
            topt.clip_by_global_norm(tree_from_numpy(g_np, "cpu"), max_norm),
            jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np),
                                     max_norm), OPT_TOL)
    np.testing.assert_allclose(
        float(topt.global_norm(tree_from_numpy(g_np, "cpu"))),
        float(jopt.global_norm(jax.tree.map(jnp.asarray, g_np))), rtol=1e-6)
    ts, js = topt.warmup_cosine(3e-3, 5, 50), jopt.warmup_cosine(3e-3, 5, 50)
    for step in (0, 1, 4, 5, 6, 27, 50, 80):
        np.testing.assert_allclose(float(ts(torch.tensor(step))),
                                   float(js(jnp.asarray(step))), rtol=1e-6)


def _gnn_case(kind):
    arch = {"gcn": "gcn-paper"}.get(kind, kind)
    cfg = jax_get_arch(arch).smoke
    key = jax.random.PRNGKey(0)
    from repro.data.graphs import random_edge_list
    s, r = random_edge_list(40, 160, seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    ef = rng.standard_normal((len(s), 4)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 40).astype(np.int32)
    mask = rng.random(40) < 0.7
    if kind == "gcn":
        jp = jgnn.gcn_init(cfg, 8, key)
    elif kind == "gatedgcn":
        jp = jgnn.gatedgcn_init(cfg, 8, 4, key)
    else:
        jp = jgnn.meshgraphnet_init(cfg, 8, 4, key)
    batch = dict(senders=s, receivers=r, node_feat=x, edge_feat=ef,
                 labels=labels, node_mask=mask)
    return arch, cfg, jp, batch


@pytest.mark.parametrize("kind", ["gcn", "gatedgcn", "meshgraphnet"])
def test_gnn_train_step_matches_reference(kind):
    arch, jcfg, jp, batch = _gnn_case(kind)
    jo = jopt.SGD(lr=5e-2, momentum=0.9, clip_norm=1.0)
    jstep = jsteps.make_gnn_train_step(jcfg, jo)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tcfg = get_arch(arch).smoke
    to = topt.SGD(lr=5e-2, momentum=0.9, clip_norm=1.0)
    tstep = tsteps.make_gnn_train_step(tcfg, to, remat=kind != "gcn")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _assert_trees_close(tp, jp, STEP_TOL)
    serve = tsteps.make_gnn_serve_step(tcfg)
    np.testing.assert_allclose(
        serve(tp, tb).numpy(),
        np.asarray(jsteps.make_gnn_serve_step(jcfg)(jp, jb)), **STEP_TOL)


@pytest.mark.parametrize("kind", ["dimenet", "nequip"])
def test_geometric_train_step_matches_reference(kind):
    """Three SGD steps of DimeNet and NequIP (energy MSE) on the shapes
    of ``tests/test_archs_smoke.py``'s ``test_geometric_smoke`` (4
    molecules of 8 atoms, smoke configs), with remat, then the serve
    step's energies. At the node models' lr of 5e-2 DimeNet's loss
    doubles at the third step and that overshoot magnifies float32
    rounding past ``STEP_TOL``; at 1e-2 it falls."""
    from repro.data.graphs import random_molecules
    from repro.models import dimenet as jdimenet
    from repro.models import nequip as jnequip
    jcfg = jax_get_arch(kind).smoke
    mols = random_molecules(4, 8, seed=0)
    fields = (jdimenet.MoleculeBatch if kind == "dimenet"
              else jnequip.AtomGraph)._fields[:-1]
    batch = {k: mols[k] for k in fields}
    batch["energy"] = np.random.default_rng(0).standard_normal(4).astype(
        np.float32)
    init = jdimenet.dimenet_init if kind == "dimenet" else \
        jnequip.nequip_init
    jp = init(jcfg, jax.random.PRNGKey(0))
    jo = jopt.SGD(lr=1e-2, momentum=0.9, clip_norm=1.0)
    jstep = jsteps.make_gnn_train_step(jcfg, jo)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tcfg = get_arch(kind).smoke
    to = topt.SGD(lr=1e-2, momentum=0.9, clip_norm=1.0)
    tstep = tsteps.make_gnn_train_step(tcfg, to, remat=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _assert_trees_close(tp, jp, STEP_TOL)
    np.testing.assert_allclose(
        tsteps.make_gnn_serve_step(tcfg, n_mols=4)(tp, tb).numpy(),
        np.asarray(jsteps.make_gnn_serve_step(jcfg, n_mols=4)(jp, jb)),
        **STEP_TOL)


def test_hybrid_gcn_train_step_matches_reference():
    """Two steps of the paper's GCN through the tri-hybrid executor (cora
    at scale 0.3, reordered by labels) against the reference's
    ``jax.value_and_grad`` + ``SGD.update``."""
    csr, x, _, st = jax_dataset("cora", scale=0.3, seed=0)
    labels = jax_dataset.last_labels
    csr2, perm, _ = jax_reorder(csr, "labels", labels=labels)
    part, meta, _ = jax_partition(csr2, JaxPartitionConfig(tile=64))
    x = x[perm]
    y = (labels[perm] % st.n_classes).astype(np.int32)
    rng = np.random.default_rng(0)
    mask = rng.random(meta.n_rows) < 0.6
    ws = [(rng.standard_normal((st.n_features, 32)) * 0.05).astype(np.float32),
          (rng.standard_normal((32, st.n_classes)) * 0.05).astype(np.float32)]
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)

    def loss_fn(w):
        logits = jax_hybrid_gcn(part, xj, w, meta=meta)
        lz = jax.nn.logsumexp(logits, -1)
        tgt = jnp.take_along_axis(logits, yj[:, None], -1)[:, 0]
        return ((lz - tgt) * mj).sum() / mj.sum()

    jo = jopt.SGD(lr=0.5, momentum=0.9)
    jw, js = [jnp.asarray(w) for w in ws], None
    js = jo.init(jw)
    losses = []
    for _ in range(2):
        loss, g = jax.value_and_grad(loss_fn)(jw)
        jw, js = jo.update(g, js, jw)
        losses.append(float(loss))

    from repro_torch.convert import partition_from_numpy
    tpart, tmeta = partition_from_numpy(part, meta)
    to = topt.SGD(lr=0.5, momentum=0.9)
    batch = {"x": torch.from_numpy(x), "labels": torch.from_numpy(y),
             "mask": torch.from_numpy(mask)}
    for backend in ("torch", "cuda"):
        step = tsteps.make_hybrid_gcn_train_step(
            tpart, to, meta=tmeta, backend=backend, device="cpu")
        tw = tree_from_numpy(ws, "cpu")
        ts = to.init(tw)
        for want in losses:
            tw, ts, m = step(tw, ts, batch)
            np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-5)
        _assert_trees_close(tw, jw, STEP_TOL)


def test_quickstart_learns_on_the_cpu():
    """The reference's ``tests/test_system.py`` on the port: cora at scale
    0.3 reordered by labels, hidden 64, 40 AdamW steps through the
    tri-hybrid executor (the ``cuda`` backend's plain versions here):
    the loss falls below 0.7x its first value, test accuracy > 0.4, and
    the serving view (``Engine.infer``) agrees with the training
    forward. Training repeats bit for bit."""
    data = quickstart.prepare("cora", scale=0.3, device="cpu")
    ws0 = quickstart.init_weights(data, hidden=64)
    ws, _, losses = quickstart.train(data, ws0, steps=40, weight_decay=0.0)
    assert losses[-1] < 0.7 * losses[0], losses
    assert quickstart.accuracy(data, ws, data["test"]) > 0.4
    with torch.no_grad():
        logits = quickstart.gcn_forward(data["part"], data["x"], ws,
                                        **quickstart.forward_kw(data))
    torch.testing.assert_close(quickstart.serve_trained(data, ws), logits,
                               **quickstart.SERVE_TOL)
    again, _, _ = quickstart.train(data, ws0, steps=5, weight_decay=0.0)
    first, _, _ = quickstart.train(data, ws0, steps=5, weight_decay=0.0)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_quickstart_main_runs_at_a_small_scale(capsys):
    assert quickstart.main(["--device", "cpu", "--scale", "0.3",
                            "--steps", "30"]) > 0.5
    assert "final test accuracy" in capsys.readouterr().out
