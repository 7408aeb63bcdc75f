"""The port's whole slice against the JAX reference on the CPU.

``repro_torch.engine.Engine(device="cpu")`` — register → ``infer`` /
``serve_group`` / ``serve_batch`` / ``spmm`` — against
``repro.engine.Engine(backend="xla")`` on small graphs with hidden 16.
Tolerance for logits: ``rtol=1e-4, atol=1e-5`` — X·W and the row sums
are added in another order than XLA's. Within the port, the kernel
backend (whose wrappers run their plain versions on CPU tensors) and the
"torch" backend agree bit for bit, and repeat runs are bitwise-equal.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
import repro_torch.core as tc
from repro_torch.engine import Engine
from repro_torch.kernels import ops

from conftest import (OVERFLOW_CFG, make_heterogeneous_matrix,
                      make_overflow_matrix)

torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
F_IN, HIDDEN, CLASSES = 24, 16, 5


def family(n_graphs=3):
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((F_IN, HIDDEN)) * 0.1).astype(np.float32),
          (rng.standard_normal((HIDDEN, CLASSES)) * 0.1).astype(np.float32)]
    mats = {f"g{i}": make_heterogeneous_matrix(300 + 4 * i, seed=i)
            for i in range(n_graphs)}
    return mats, ws, rng


@pytest.fixture(scope="module")
def engines():
    mats, ws, rng = family()
    ref = re_.Engine(backend="xla")
    port = Engine(device="cpu")
    plain = Engine(device="cpu", backend="torch")
    for name, a in mats.items():
        ref.register(name, rc.csr_from_dense(a), weights=ws)
        port.register(name, tc.csr_from_dense(a), weights=ws)
        plain.register(name, tc.csr_from_dense(a), weights=ws)
    reqs = [(name, rng.standard_normal((mats[name].shape[0], F_IN)
                                       ).astype(np.float32))
            for name in ("g0", "g1", "g2", "g1", "g0")]
    return ref, port, plain, mats, reqs


def test_classes_match_reference(engines):
    ref, port, _, mats, _ = engines
    for name in mats:
        assert ref.handle(name).sclass.summary() == \
            port.handle(name).sclass.summary()
    assert ref.stats()["shape_classes"] == port.stats()["shape_classes"]


def test_infer_matches_reference(engines):
    ref, port, plain, _, reqs = engines
    for name, x in reqs[:3]:
        want = np.asarray(ref.infer(name, x))
        got = port.infer(name, x)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        assert torch.equal(got, plain.infer(name, x))
        assert torch.equal(got, port.infer(name, x))      # repeatable


def test_serve_batch_matches_reference_and_infer(engines):
    ref, port, _, _, reqs = engines
    want = ref.serve_batch(reqs)
    got = port.serve_batch(reqs)
    assert len(got) == len(reqs)
    for (name, x), y, w in zip(reqs, got, want):
        np.testing.assert_allclose(y.numpy(), np.asarray(w), **LOGIT_TOL)
        np.testing.assert_allclose(y.numpy(), port.infer(name, x).numpy(),
                                   **LOGIT_TOL)
    again = port.serve_batch(reqs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_serve_group_one_dispatch_and_stack_cache(engines):
    _, port, _, _, reqs = engines
    group = [(n, x) for n, x in reqs if n == "g1"] + [reqs[0]]
    hits0, misses0 = port.stack_hits, port.stack_misses
    outs, meta = port.serve_group_async(group)
    assert meta["ready"]() is True
    meta["complete"]()
    assert [tuple(y.shape) for y in outs] == [
        (port.handle(n).n_rows, CLASSES) for n, _ in group]
    port.serve_group(list(reversed(group)))   # same members: stack reused
    assert port.stack_misses == misses0 + 1
    assert port.stack_hits == hits0 + 1
    st = port.stats()
    for key in ("graphs", "shape_classes", "executors", "cache_hits",
                "cache_misses", "cache_evictions", "per_class", "registry",
                "stacks", "stack_hits", "stack_misses", "stack_evictions"):
        assert key in st


def test_executor_cache_lru_and_invalidation():
    mats, ws, rng = family(2)
    eng = Engine(device="cpu", executor_max_entries=1)
    for name, a in mats.items():
        eng.register(name, tc.csr_from_dense(a), weights=ws)
    sc = eng.handle("g0").sclass
    x = rng.standard_normal((300, F_IN)).astype(np.float32)
    eng.infer("g0", x)
    eng.infer("g0", x)
    eng.spmm("g0", x[:, :3])                  # evicts the gcn executor
    st = eng.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_evictions"]) \
        == (1, 2, 1)
    assert eng.executors.invalidate_class(sc) == 1
    assert eng.executors.size == 0
    assert eng.executors.stats_snapshot()["invalidations"] == 1


def test_group_launches_counted_once_per_layer_on_cuda_only(engines):
    _, port, _, _, reqs = engines
    ops.reset_launch_counts()
    port.serve_batch(reqs)
    # CPU tensors take the plain versions: nothing is launched
    assert ops.launch_counts() == {"bsr_spmm": 0, "ragged_ell_spmm": 0,
                                   "ell_spmm": 0, "tile_matmul": 0}


def test_spmm_matches_reference(engines):
    ref, port, _, mats, _ = engines
    b = np.random.default_rng(3).standard_normal((304, 9)).astype(np.float32)
    want = np.asarray(ref.spmm("g1", b))
    got = port.spmm("g1", b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), mats["g1"] @ b, rtol=1e-4,
                               atol=1e-4)


def test_reorder_round_trip_matches_reference():
    a = make_heterogeneous_matrix(200, seed=3)
    sym = np.abs(a) + np.abs(a).T
    rng = np.random.default_rng(1)
    ws = [(rng.standard_normal((16, 8)) * 0.1).astype(np.float32),
          (rng.standard_normal((8, 3)) * 0.1).astype(np.float32)]
    x = rng.standard_normal((200, 16)).astype(np.float32)
    ref = re_.Engine()
    ref.register("r", rc.csr_from_dense(sym), reorder="degree", weights=ws)
    port = Engine(device="cpu")
    port.register("r", tc.csr_from_dense(sym), reorder="degree", weights=ws)
    np.testing.assert_allclose(port.infer("r", x).numpy(),
                               np.asarray(ref.infer("r", x)), **LOGIT_TOL)


EDGE_CASES = {
    "empty": (lambda: np.zeros((100, 100), np.float32), dict(tile=64)),
    "all_dense": (lambda: np.abs(np.random.default_rng(2).standard_normal(
        (64, 64))).astype(np.float32), dict(tile=64)),
    "ell_overflow": (make_overflow_matrix, OVERFLOW_CFG),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_hybrid_spmm_edge_cases(name, backend):
    make, cfg = EDGE_CASES[name]
    a = make()
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(**cfg))
    b = np.random.default_rng(0).standard_normal((a.shape[1], 16)).astype(
        np.float32)
    y = tc.hybrid_spmm(part, b, meta=meta, backend=backend, device="cpu")
    np.testing.assert_allclose(y.numpy(), a @ b, rtol=2e-5, atol=2e-4)
    ref_part, ref_meta, _ = rc.analyze_and_partition(
        rc.csr_from_dense(a), rc.PartitionConfig(**cfg))
    want = np.asarray(rc.hybrid_spmm(ref_part, b, meta=ref_meta))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


def test_hybrid_spmm_group_axis_bitwise_equals_members():
    """A stacked group (leading axis on every leaf and on B, plan built
    on the fly) gives each member exactly its own result."""
    from repro_torch.core.formats import TriPartition
    from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
    reg = ClassRegistry()
    padded, rng = [], np.random.default_rng(5)
    for i in range(2):
        a = make_heterogeneous_matrix(300 + 4 * i, seed=i)
        part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                                 tc.PartitionConfig(tile=64))
        padded.append(pad_to_class(part, meta, reg.classify(part, meta)))
    meta = padded[0][1]
    stack = TriPartition(*(type(c)(*(np.stack(leaves)
                                     for leaves in zip(*comps)))
                           for c, comps in zip(padded[0][0],
                                               zip(*[p for p, _ in padded]))))
    b = rng.standard_normal((2, meta.n_cols, 6)).astype(np.float32)
    for backend in ("torch", "cuda"):
        y = tc.hybrid_spmm(stack, b, meta=meta, backend=backend,
                           device="cpu")
        for i, (p, m) in enumerate(padded):
            assert torch.equal(y[i], tc.hybrid_spmm(
                p, b[i], meta=m, backend=backend, device="cpu"))


def test_gcn_forward_block_cols_matches_unblocked():
    a = make_heterogeneous_matrix(300, seed=0)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    mats, ws, rng = family(1)
    x = rng.standard_normal((300, F_IN)).astype(np.float32)
    y0 = tc.gcn_forward(part, x, ws, meta=meta, device="cpu")
    h1 = tc.gcn_layer(part, x, ws[0], meta=meta, activation=torch.relu,
                      device="cpu")
    assert torch.equal(y0, tc.gcn_layer(part, h1, ws[1], meta=meta,
                                        device="cpu"))
    y1 = tc.gcn_forward(part, x, ws, meta=meta, block_cols=4, device="cpu")
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-6)
    h = np.maximum(a @ (x @ ws[0]), 0)
    np.testing.assert_allclose(y0.numpy(), a @ (h @ ws[1]), rtol=1e-4,
                               atol=1e-4)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine()
    a = make_heterogeneous_matrix(64, seed=0)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    b = np.ones((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.hybrid_spmm(part, b, meta=meta)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.gcn_forward(part, b, [np.ones((4, 2), np.float32)], meta=meta)


def test_engine_rejects_what_it_cannot_serve():
    with pytest.raises(ValueError, match="unknown ell dispatch"):
        Engine(device="cpu", ell_dispatch="bogus")
    with pytest.raises(ValueError, match="backend"):
        Engine(device="cpu", backend="xla")
    eng = Engine(device="cpu")
    eng.register("g", tc.csr_from_dense(make_heterogeneous_matrix(64)))
    with pytest.raises(ValueError, match="without weights"):
        eng.serve_batch([("g", np.ones((64, 4), np.float32))])
    with pytest.raises(ValueError, match="rows"):
        eng.spmm("g", np.ones((63, 4), np.float32))
