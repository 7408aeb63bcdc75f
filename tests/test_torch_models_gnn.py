"""The port's GNN model zoo and shared blocks against the reference.

Weights are made by the reference's initializers and carried into the
port (``convert.tree_from_numpy``); inputs are numpy from a seed. Each
forward is held within ``FWD_TOL`` of the reference's (float32; matmuls
and segment sums in other orders). The port's gather and segment sum
(``models.common.take``/``segment_sum``) sum by a host plan in both
directions; their gradients are held against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.graphs import random_edge_list as jax_random_edge_list
from repro.models import common as jcommon
from repro.models import gnn as jgnn
import repro_torch.core as tc
from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.core.hybrid_spmm import hybrid_spmm
from repro_torch.data.graphs import normalized_adjacency, random_edge_list
from repro_torch.models import common, gnn
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
KINDS = ("gcn", "gatedgcn", "meshgraphnet")
ARCH = {"gcn": "gcn-paper", "gatedgcn": "gatedgcn",
        "meshgraphnet": "meshgraphnet"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **tol)


def graph_inputs(n=40, e=160, d_in=8, d_edge=4, seed=0):
    s, r = random_edge_list(n, e, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    ef = rng.standard_normal((len(s), d_edge)).astype(np.float32)
    return s, r, x, ef


def reference_model(kind, d_in, d_edge):
    cfg = jax_get_arch(ARCH[kind]).smoke
    if kind == "gcn":
        return cfg, jgnn.gcn_init(cfg, d_in, KEY)
    if kind == "gatedgcn":
        return cfg, jgnn.gatedgcn_init(cfg, d_in, d_edge, KEY)
    return cfg, jgnn.meshgraphnet_init(cfg, d_in, d_edge, KEY)


FORWARDS = {"gcn": (jgnn.gcn_forward, gnn.gcn_forward),
            "gatedgcn": (jgnn.gatedgcn_forward, gnn.gatedgcn_forward),
            "meshgraphnet": (jgnn.meshgraphnet_forward,
                             gnn.meshgraphnet_forward)}


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_reference(kind):
    s, r, x, ef = graph_inputs()
    cfg, jp = reference_model(kind, 8, 4)
    jf, tf = FORWARDS[kind]
    want = jf(jp, jgnn.Graph(jnp.asarray(s), jnp.asarray(r), jnp.asarray(x),
                             jnp.asarray(ef)), cfg)
    tp = tree_from_numpy(_np(jp), "cpu")
    g = gnn.Graph(torch.from_numpy(s), torch.from_numpy(r),
                  torch.from_numpy(x), torch.from_numpy(ef))
    cfg = get_arch(ARCH[kind]).smoke
    _close(tf(tp, g, cfg), want)
    if kind != "gcn":         # remat recomputes the same layer
        torch.testing.assert_close(tf(tp, g, cfg, remat=True),
                                   tf(tp, g, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_init_shapes_match_reference(kind):
    cfg, jp = reference_model(kind, 8, 4)
    gen = torch.Generator().manual_seed(0)
    if kind == "gcn":
        tp = gnn.gcn_init(cfg, 8, gen, device="cpu")
    elif kind == "gatedgcn":
        tp = gnn.gatedgcn_init(cfg, 8, 4, gen, device="cpu")
    else:
        tp = gnn.meshgraphnet_init(cfg, 8, 4, gen, device="cpu")
    want = jax.tree_util.tree_leaves(jp)
    assert common.count_params(tp) == jcommon.count_params(jp)
    assert [tuple(t.shape) for t in tree_leaves(tp)] == [
        tuple(w.shape) for w in want]


def test_gatedgcn_padding_edges_noop():
    """Edges pointing at a sentinel node with zero features must not
    change real nodes' outputs (the minibatch padding contract)."""
    cfg = get_arch("gatedgcn").smoke
    rng = np.random.default_rng(0)
    s, r = random_edge_list(30, 120, seed=2)
    x = rng.standard_normal((31, 8)).astype(np.float32)
    x[30] = 0.0
    e = rng.standard_normal((len(s), 4)).astype(np.float32)
    params = gnn.gatedgcn_init(cfg, 8, 4, torch.Generator().manual_seed(0),
                               device="cpu")
    g1 = gnn.Graph(torch.from_numpy(s), torch.from_numpy(r),
                   torch.from_numpy(x), torch.from_numpy(e))
    sp_ = np.concatenate([s, np.full(40, 30, np.int32)])
    rp = np.concatenate([r, np.full(40, 30, np.int32)])
    ep = np.concatenate([e, np.zeros((40, 4), np.float32)])
    g2 = gnn.Graph(torch.from_numpy(sp_), torch.from_numpy(rp),
                   torch.from_numpy(x), torch.from_numpy(ep))
    out1 = gnn.gatedgcn_forward(params, g1, cfg)
    out2 = gnn.gatedgcn_forward(params, g2, cfg)
    torch.testing.assert_close(out1[:30], out2[:30], rtol=2e-5, atol=1e-5)


def test_gcn_hybrid_equals_segment_sum():
    """The paper's GCN aggregation via TriPartition == A_tilde @ (X W)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    n, f, h = 120, 24, 16
    s, r = random_edge_list(n, 600, seed=3)
    a = sp.coo_matrix((np.ones(len(s)), (r, s)), shape=(n, n)).tocsr()
    atil = normalized_adjacency(a)
    part, meta, _ = tc.analyze_and_partition(
        tc.csr_from_dense(atil.toarray()), tc.PartitionConfig(tile=64))
    x = rng.standard_normal((n, f)).astype(np.float32)
    w1 = (rng.standard_normal((f, h)) * 0.2).astype(np.float32)
    want = atil.toarray() @ (x @ w1)
    # the edge-list form: self loops as edges, weights from A_tilde
    coo = atil.tocoo()
    seg = common.segment_sum(
        torch.from_numpy(coo.data.astype(np.float32))[:, None]
        * common.take(torch.from_numpy(x @ w1), torch.from_numpy(coo.col)),
        torch.from_numpy(coo.row), n)
    for backend in ("torch", "cuda"):
        got = hybrid_spmm(part, torch.from_numpy(x @ w1), meta=meta,
                          backend=backend, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), seg.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_random_edge_list_equals_reference():
    for n, e, seed in ((40, 160, 0), (300, 2000, 5)):
        for a, b in zip(random_edge_list(n, e, seed=seed),
                        jax_random_edge_list(n, e, seed=seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ blocks ----
def test_take_and_segment_sum_gradients_match_jax():
    rng = np.random.default_rng(1)
    n, e, d = 17, 60, 5
    idx = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)

    def jfn(x):
        msgs = jnp.take(x, idx, axis=0) * 1.5
        return jnp.sum(jax.ops.segment_sum(msgs, dst, num_segments=n) * cot)

    want = jax.grad(jfn)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = common.segment_sum(common.take(xt, idx) * 1.5, dst, n)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, want, dict(rtol=1e-5, atol=1e-5))
    _close(out, jax.ops.segment_sum(jnp.take(jnp.asarray(x), idx, axis=0)
                                    * 1.5, dst, num_segments=n),
           dict(rtol=1e-5, atol=1e-5))


def test_blocks_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 2, 8)).astype(np.float32)
    sc = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    t = torch.from_numpy
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(common.rms_norm(t(x), t(sc)), jcommon.rms_norm(x, sc), tol)
    _close(common.layer_norm(t(x), t(sc), t(b)),
           jcommon.layer_norm(x, sc, b), tol)
    pos = np.arange(6)
    _close(common.apply_rope(t(x), t(pos)), jcommon.apply_rope(x, pos), tol)
    wg, wu, wd = (rng.standard_normal(s).astype(np.float32)
                  for s in ((8, 5), (8, 5), (5, 3)))
    _close(common.swiglu(t(x), t(wg), t(wu), t(wd)),
           jcommon.swiglu(x, wg, wu, wd), tol)
    logits = rng.standard_normal(20).astype(np.float32)
    seg = np.sort(rng.integers(0, 6, 20))
    _close(common.segment_softmax(t(logits), t(seg), 7),
           jcommon.segment_softmax(jnp.asarray(logits), jnp.asarray(seg), 7),
           tol)
    table = rng.standard_normal((10, 3)).astype(np.float32)
    ids = rng.integers(0, 10, 9)
    offs = np.array([0, 2, 2, 5])
    for mode in ("sum", "mean"):
        _close(common.embedding_bag(t(table), t(ids), t(offs), mode=mode),
               jcommon.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(offs), mode=mode), tol)
    _close(common.embedding_bag(t(table), t(ids)), table[ids], tol)
    params = [(rng.standard_normal((8, 4)).astype(np.float32),
               rng.standard_normal(4).astype(np.float32)),
              (rng.standard_normal((4, 2)).astype(np.float32),
               np.zeros(2, np.float32))]
    _close(common.mlp(t(x), tree_from_numpy(params, "cpu")),
           jcommon.mlp(x, params), tol)


def test_initializers_use_the_generator():
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a = common.uniform_init(g1, (64, 32))
    assert torch.equal(a, common.uniform_init(g2, (64, 32)))
    assert float(a.abs().max()) <= 1 / np.sqrt(64)
    n = common.normal_init(g1, (1000,), stddev=0.5)
    assert abs(float(n.std()) - 0.5) < 0.05
    mlp = common.init_mlp(torch.Generator().manual_seed(0), [8, 4, 2])
    assert [tuple(w.shape) for w, _ in mlp] == [(8, 4), (4, 2)]
