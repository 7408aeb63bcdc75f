"""Gradients of the port's tri-hybrid GCN against the JAX reference.

``repro_torch.core.hybrid_spmm.gcn_forward`` is differentiated through
``HybridSpmmFn``, whose backward is ``dB = Aᵀ·dY`` run by the same
executor over Aᵀ's own tri-partition. The weight gradients of the
masked cross-entropy are held against ``jax.value_and_grad`` of the
reference's ``gcn_forward`` (its ``xla`` backend) on the same numpy
inputs, within ``GRAD_TOL`` (float32; the two sum X·W's and the SpMM's
terms in other orders).

The paper graphs are exactly symmetric (``dinv[i]·dinv[j]`` commutes),
so a backward that used A where it needs Aᵀ would pass on them: every
comparison includes an asymmetric graph, and
``test_a_in_place_of_at_fails_the_asymmetric_case`` shows that such a
backward fails there.

JAX is imported only inside the CPU tests, so that the ``cuda`` tests run
where JAX is not installed.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch.core as tc
from repro_torch.core.formats import partition_to_dense
from repro_torch.core.partition import (config_of, is_symmetric,
                                        partition_entries,
                                        transpose_partition)
from repro_torch.data.graphs import make_paper_dataset
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.train.steps import masked_xent

from conftest import make_heterogeneous_matrix

# the module (``repro_torch.core`` re-exports a function of its name)
hs = importlib.import_module("repro_torch.core.hybrid_spmm")
torch.set_num_threads(2)

# weight gradients vs the reference: |g - g_ref| <= atol + rtol * |g_ref|
# with atol relative to the gradient's largest entry (float32 sums of
# up to 1433 X·W terms and the aggregation, taken in other orders)
GRAD_TOL = dict(rtol=2e-4, atol_frac=2e-5)
HIDDEN = 16
DISPATCHES = ("ragged", "fused", "loop")


def _cora_labels():
    csr, x, _, st = make_paper_dataset("cora", scale=0.3, seed=0)
    labels = make_paper_dataset.last_labels
    csr2, perm, _ = tc.reorder(csr, "labels", labels=labels)
    return csr2, x[perm], (labels[perm] % st.n_classes)


def _hetero(symmetric: bool):
    a = make_heterogeneous_matrix(300, seed=0)
    if symmetric:
        a = (a + a.T) * np.float32(0.5)
    rng = np.random.default_rng(1)
    return (tc.csr_from_dense(a),
            rng.standard_normal((300, 24)).astype(np.float32),
            rng.integers(0, 5, 300))


def _pubmed_asym():
    """Pubmed's pattern with a random value per edge: not symmetric."""
    csr, x, _, st = make_paper_dataset("pubmed", scale=0.05, seed=0)
    rng = np.random.default_rng(2)
    a = sp.csr_matrix((rng.random(csr.data.shape[0]).astype(np.float32),
                       csr.indices, csr.indptr), shape=csr.shape)
    return tc.csr_from_scipy(a), x, rng.integers(0, st.n_classes,
                                                 csr.shape[0])


# name -> (builder, symmetric)
GRAPHS = {
    "cora_labels": (_cora_labels, True),        # all ELL (+ COO)
    "hetero_sym": (lambda: _hetero(True), True),   # dense + ELL + COO
    "hetero_asym": (lambda: _hetero(False), False),
    "pubmed_asym": (_pubmed_asym, False),
}
_CACHE = {}


def graph(name):
    if name not in _CACHE:
        csr, x, y = GRAPHS[name][0]()
        part, meta, _ = tc.analyze_and_partition(
            csr, tc.PartitionConfig(tile=64))
        rng = np.random.default_rng(3)
        n_cls = int(y.max()) + 1
        ws = [(rng.standard_normal((x.shape[1], HIDDEN)) * 0.1
               ).astype(np.float32),
              (rng.standard_normal((HIDDEN, n_cls)) * 0.1
               ).astype(np.float32)]
        mask = rng.random(meta.n_rows) < 0.6
        _CACHE[name] = dict(csr=csr, part=part, meta=meta, x=x,
                            y=y.astype(np.int64), ws=ws, mask=mask)
    return _CACHE[name]


def port_grads(g, *, backend="torch", ell_dispatch="ragged",
               block_cols=0, device="cpu", part=None):
    ws = [torch.tensor(w, device=device, requires_grad=True)
          for w in g["ws"]]
    logits = hs.gcn_forward(g["part"] if part is None else part, g["x"], ws,
                            meta=g["meta"], backend=backend,
                            ell_dispatch=ell_dispatch, block_cols=block_cols,
                            device=device)
    loss = masked_xent(logits, torch.as_tensor(g["y"], device=device),
                       torch.as_tensor(g["mask"], device=device))
    loss.backward()
    return float(loss.detach()), [w.grad for w in ws]


def reference_grads(g):
    import jax
    import jax.numpy as jnp

    from repro.core.hybrid_spmm import gcn_forward as jax_gcn
    from repro.core.partition import PartitionConfig, analyze_and_partition
    from repro.core.formats import CSRMatrix

    csr = g["csr"]
    part, meta, _ = analyze_and_partition(
        CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape),
        PartitionConfig(tile=64))
    x, y = jnp.asarray(g["x"]), jnp.asarray(g["y"])
    m = jnp.asarray(g["mask"], jnp.float32)

    def loss_fn(ws):
        logits = jax_gcn(part, x, ws, meta=meta, backend="xla")
        lz = jax.nn.logsumexp(logits, -1)
        tgt = jnp.take_along_axis(logits, y[:, None], -1)[:, 0]
        return jnp.sum((lz - tgt) * m) / jnp.maximum(m.sum(), 1.0)

    loss, gr = jax.value_and_grad(loss_fn)([jnp.asarray(w)
                                           for w in g["ws"]])
    return float(loss), [np.asarray(v) for v in gr]


def grads_close(got, want) -> bool:
    for a, b in zip(got, want):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        atol = GRAD_TOL["atol_frac"] * float(np.abs(b).max())
        if not np.all(np.abs(a - b) <= atol + GRAD_TOL["rtol"] * np.abs(b)):
            return False
    return True


@pytest.mark.parametrize("backend", hs.BACKENDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_weight_grads_match_reference(name, backend):
    g = graph(name)
    assert is_symmetric(tc.partition_to(g["part"], "cpu"),
                        g["meta"]) == GRAPHS[name][1]
    loss, got = port_grads(g, backend=backend)
    want_loss, want = reference_grads(g)
    assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    assert grads_close(got, want)


def test_a_in_place_of_at_fails_the_asymmetric_case(monkeypatch):
    """A backward that multiplied by A instead of Aᵀ (here: the adjoint
    builder patched to hand back A's own partition) still matches the
    reference on the symmetric paper graph, and fails on the asymmetric
    ones: the case the asymmetric graphs are there for."""
    monkeypatch.setattr(hs, "transpose_partition",
                        lambda part, meta: (part, meta))
    monkeypatch.setattr(hs, "ADJOINTS", hs.AdjointCache())
    g = graph("cora_labels")
    assert grads_close(port_grads(g)[1], reference_grads(g)[1])
    for name in ("hetero_asym", "pubmed_asym"):
        g = graph(name)
        assert not grads_close(port_grads(g)[1], reference_grads(g)[1])


@pytest.mark.parametrize("name", ["hetero_asym", "cora_labels"])
def test_dispatches_and_backends_give_the_same_gradient_bits(name):
    g = graph(name)
    _, want = port_grads(g, backend="torch")
    for backend in hs.BACKENDS:
        for d in DISPATCHES:
            _, got = port_grads(g, backend=backend, ell_dispatch=d)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                backend, d)


def test_block_cols_gradient_matches():
    g = graph("hetero_asym")
    _, want = port_grads(g)
    _, got = port_grads(g, block_cols=6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_spmm_gradient_in_b_on_a_rectangular_matrix():
    """dB = Aᵀ·dY for A [300, 200]: B's rows follow A's columns."""
    rng = np.random.default_rng(4)
    a = make_heterogeneous_matrix(300, seed=5)[:, :200]
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    b = torch.tensor(rng.standard_normal((200, 7)).astype(np.float32),
                     requires_grad=True)
    dy = torch.tensor(rng.standard_normal((300, 7)).astype(np.float32))
    for backend in hs.BACKENDS:
        b.grad = None
        y = hs.hybrid_spmm(part, b, meta=meta, backend=backend,
                           device="cpu")
        (y * dy).sum().backward()
        torch.testing.assert_close(b.grad, torch.from_numpy(a.T) @ dy,
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_transpose_partition_is_at(name):
    g = graph(name)
    part_t, meta_t = transpose_partition(g["part"], g["meta"])
    if GRAPHS[name][1]:
        assert part_t is g["part"] and meta_t is g["meta"]
        return
    a = partition_to_dense(g["part"], g["meta"])
    np.testing.assert_array_equal(partition_to_dense(part_t, meta_t), a.T)
    r, c, v = partition_entries(g["part"], g["meta"])
    assert r.shape[0] == np.count_nonzero(a)


def test_transpose_partition_keeps_the_partition_config():
    """Aᵀ is partitioned under the ``PartitionConfig`` A was, Algorithm
    2's delta/p and Algorithm 1's tau included (non-default here, and
    tau changes the split); a meta built without one falls back to the
    defaults."""
    g = graph("hetero_asym")
    cfg = tc.PartitionConfig(tile=64, delta=8.0, p=0.7, tau=0.8)
    part, meta, _ = tc.analyze_and_partition(g["csr"], cfg)
    assert config_of(part, meta) == cfg
    part_t, meta_t = transpose_partition(part, meta)
    np.testing.assert_array_equal(partition_to_dense(part_t, meta_t),
                                  partition_to_dense(part, meta).T)
    at = tc.csr_from_scipy(tc.csr_to_scipy(g["csr"]).T.tocsr())
    want = tc.analyze_and_partition(at, cfg)[1]
    default = tc.analyze_and_partition(at, tc.PartitionConfig(tile=64))[1]
    assert dataclasses.asdict(meta_t) == dataclasses.asdict(want)
    assert dataclasses.asdict(meta_t) != dataclasses.asdict(default)
    assert meta_t.config == cfg
    assert config_of(part, dataclasses.replace(meta)) == dataclasses.replace(
        tc.PartitionConfig(), tile=64)


def test_adjoint_is_built_once_per_partition(monkeypatch):
    cache = hs.AdjointCache()
    monkeypatch.setattr(hs, "ADJOINTS", cache)
    for name in ("hetero_asym", "cora_labels"):
        g = graph(name)
        for _ in range(3):
            port_grads(g)
    st = cache.stats()
    assert (st["checks"], st["builds"], st["cached"]) == (2, 1, 2)


def test_member_matmul_same_bits_with_grad_on_and_off():
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((3, 50, 33)).astype(np.float32))
    for w_members in (1, 3):
        w = torch.tensor(rng.standard_normal((w_members, 33, 9))
                         .astype(np.float32))
        with torch.no_grad():
            off = hs.member_matmul(x, w)
        on = hs.member_matmul(x, w.clone().requires_grad_(True))
        assert on.grad_fn is not None
        assert torch.equal(on.detach(), off)


def _grouped_members():
    """Two asymmetric graphs padded to one shape class, stacked."""
    from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
    reg, padded = ClassRegistry(), []
    for i in range(2):
        a = make_heterogeneous_matrix(300 + 4 * i, seed=i)
        part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                                 tc.PartitionConfig(tile=64))
        padded.append(pad_to_class(part, meta, reg.classify(part, meta)))
    meta = padded[0][1]
    stack = tc.TriPartition(*(type(c)(*(np.stack(leaves)
                                        for leaves in zip(*comps)))
                              for c, comps in zip(padded[0][0],
                                                  zip(*[p for p, _ in
                                                        padded]))))
    return padded, stack, meta


@pytest.mark.parametrize("backend", hs.BACKENDS)
def test_grouped_gradient_has_each_members_bits(backend):
    """Under grad a grouped partition (G = 2) runs each member through
    ``HybridSpmmFn`` alone: the forward keeps the grouped forward's
    bits, and each member's weight gradients (over its own Aᵀ) have the
    bits of that member differentiated at G = 1."""
    padded, stack, meta = _grouped_members()
    assert not any(is_symmetric(p, m) for p, m in padded)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, meta.n_rows, 12)).astype(np.float32)
    ws_np = [(rng.standard_normal((2, 12, HIDDEN)) * 0.1).astype(np.float32),
             (rng.standard_normal((2, HIDDEN, 5)) * 0.1).astype(np.float32)]
    y = rng.integers(0, 5, (2, meta.n_rows))
    mask = rng.random((2, meta.n_rows)) < 0.6

    def loss_of(logits, i):
        return masked_xent(logits, torch.as_tensor(y[i]),
                           torch.as_tensor(mask[i]))

    ws = [torch.tensor(w, requires_grad=True) for w in ws_np]
    out = hs.gcn_forward(stack, x, ws, meta=meta, backend=backend,
                         device="cpu")
    with torch.no_grad():
        grouped = hs.gcn_forward(stack, x, ws, meta=meta, backend=backend,
                                 device="cpu")
    assert out.grad_fn is not None and torch.equal(out.detach(), grouped)
    sum(loss_of(out[i], i) for i in range(2)).backward()
    for i, (p, m) in enumerate(padded):
        alone = [torch.tensor(w[i], requires_grad=True) for w in ws_np]
        logits = hs.gcn_forward(p, x[i], alone, meta=m, backend=backend,
                                device="cpu")
        assert torch.equal(logits.detach(), grouped[i])
        loss_of(logits, i).backward()
        for w, a in zip(ws, alone):
            assert torch.equal(w.grad[i], a.grad)


def test_hand_kernel_share_of_the_gradient_is_kept(monkeypatch):
    """The kernel wrappers fill their outputs through ``data_ptr()``, so
    on the card those outputs carry no ``grad_fn``. Patched here to plain
    versions that do the same, the ``cuda`` backend's gradient must still
    equal the ``torch`` backend's: the backward may not drop the dense
    and ELL engines' share, and it runs them (over Aᵀ)."""
    def dense(part, b, meta, plan):
        return hs.dense_tiles_matmul(part, b, meta, plan).detach()

    def ell(part, b, meta, plan, yd, *, dispatch="ragged", ell_tune=None):
        if part.ell.cols.shape[-3] == 0:
            return yd
        return kref.ragged_ell_rows_ref(
            part.ell.cols, part.ell.vals, part.ell.tile_col, part.ell.unit_k,
            tc.formats.b_tiles_of(b, meta), plan.ell, yd).detach()

    monkeypatch.setattr(kops, "dense_tiles_matmul", dense)
    monkeypatch.setattr(kops, "ell_matmul", ell)
    for name in ("hetero_asym", "pubmed_asym"):
        g = graph(name)
        _, want = port_grads(g, backend="torch")
        _, got = port_grads(g, backend="cuda")
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_backward_runs_the_kernel_wrappers():
    g = graph("hetero_asym")
    port_grads(g, backend="cuda")          # builds Aᵀ first
    kops.reset_entry_counts()
    ws = [torch.tensor(w, requires_grad=True) for w in g["ws"]]
    logits = hs.gcn_forward(g["part"], g["x"], ws, meta=g["meta"],
                            backend="cuda", device="cpu")
    fwd = kops.entry_counts()
    logits.square().sum().backward()
    total = kops.entry_counts()
    bwd = {k: total[k] - fwd.get(k, 0) for k in total}
    assert fwd == {"bsr_spmm_rows": 2, "ragged_ell_rows": 2, "coo_rows": 2}
    assert bwd == {"bsr_spmm_rows": 2, "ragged_ell_rows": 2, "coo_rows": 2}


# ------------------------------------------------------------- card ----
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cora_labels", "hetero_sym",
                                  "pubmed_asym"])
def test_card_backward_kernels_match_the_plain_backend(name):
    """On the card the backward launches the hand kernels over Aᵀ: its
    gradient is within ``GRAD_TOL`` of the plain ``torch`` backend's on
    the card, bitwise-equal across the ELL dispatches and from run to
    run, with one launch of each kernel per layer forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = graph(name)
    part = tc.partition_to(g["part"], "cuda")
    _, want = port_grads(g, backend="torch", device="cuda", part=part)
    _, first = port_grads(g, backend="cuda", device="cuda", part=part)
    assert grads_close(first, [w.cpu().numpy() for w in want])
    for d in DISPATCHES:
        _, got = port_grads(g, backend="cuda", ell_dispatch=d,
                            device="cuda", part=part)
        assert all(torch.equal(a, b) for a, b in zip(got, first)), d
    kops.reset_launch_counts()
    port_grads(g, backend="cuda", device="cuda", part=part)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    both = (g["part"], transpose_partition(g["part"], g["meta"])[0])
    assert counts["ragged_ell_spmm"] == 2 * sum(
        p.ell.cols.shape[0] > 0 for p in both)
    assert counts["bsr_spmm"] == 2 * sum(
        p.dense.tiles.shape[0] > 0 for p in both)
    assert counts["coo_rows"] == 2 * sum(
        p.coo.vals.shape[0] > 0 for p in both)
