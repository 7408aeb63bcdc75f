"""The port's planted labels, the "labels" reorder and the ``core`` surface
against the JAX reference.

``repro_torch.data.graphs`` draws the same SBM graphs as
``repro.data.graphs``: the CSR and the planted communities
(``sbm_graph(..., return_labels=True)``, ``make_paper_dataset.last_labels``)
must equal the reference's exactly. Only the features' seed differs by
design (a CRC32 of the name, where the reference uses ``hash(name)``), so
the features are not compared. The ``"labels"`` reorder of the port must
give the reference's permutation exactly, and the port's ``core`` must
export every name of the reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as rc
import repro.data.graphs as rg
import repro_torch.core as tc
import repro_torch.data.graphs as tg
from repro_torch.engine import Engine

GRAPHS = ("cora", "citeseer", "pubmed")
SCALES = (0.05, 0.15)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", GRAPHS)
def test_paper_dataset_csr_and_labels_equal_the_reference(name, scale):
    got, _, _, st = tg.make_paper_dataset(name, scale=scale, seed=3)
    got_labels = tg.make_paper_dataset.last_labels
    want, _, _, ref_st = rg.make_paper_dataset(name, scale=scale, seed=3)
    want_labels = rg.make_paper_dataset.last_labels
    for field in ("indptr", "indices", "data"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b)
    assert got.shape == want.shape
    assert got_labels.dtype == want_labels.dtype
    np.testing.assert_array_equal(got_labels, want_labels)
    assert got_labels.shape == (got.shape[0],)
    assert (st.name, st.n_features, st.n_classes) == (
        ref_st.name, ref_st.n_features, ref_st.n_classes)


@pytest.mark.parametrize("return_labels", [False, True])
def test_sbm_graph_return_labels_matches_reference(return_labels):
    got = tg.sbm_graph(300, 2400, seed=5, return_labels=return_labels)
    want = rg.sbm_graph(300, 2400, seed=5, return_labels=return_labels)
    if return_labels:
        (got, got_comm), (want, want_comm) = got, want
        np.testing.assert_array_equal(got_comm, want_comm)
        assert got_comm.max() < max(300 // 112, 2)
    assert (got != want).nnz == 0
    np.testing.assert_array_equal(got.indptr, want.indptr)


@pytest.mark.parametrize("name", GRAPHS)
def test_labels_reorder_equals_the_reference_permutation(name):
    csr, _, _, _ = tg.make_paper_dataset(name, scale=0.1, seed=0)
    labels = tg.make_paper_dataset.last_labels
    ref_csr, _, _, _ = rg.make_paper_dataset(name, scale=0.1, seed=0)
    ref_labels = rg.make_paper_dataset.last_labels
    got, perm, _ = tc.reorder(csr, "labels", labels=labels)
    want, ref_perm, _ = rc.reorder(ref_csr, "labels", labels=ref_labels)
    np.testing.assert_array_equal(perm, ref_perm)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    # grouping by planted community pulls the nnz towards the diagonal
    assert tc.bandwidth(got) <= tc.bandwidth(csr)
    assert np.all(np.diff(labels[perm]) >= 0)


def test_engine_serves_a_labels_reordered_graph():
    """The engine's ``reorder="labels"`` path: logits in the graph's own
    vertex order, equal to the unreordered graph's within tolerance."""
    csr, x, _, st = tg.make_paper_dataset("cora", scale=0.1, seed=0)
    labels = tg.make_paper_dataset.last_labels
    rng = np.random.default_rng(0)
    ws = [rng.uniform(-0.1, 0.1, (st.n_features, 16)).astype(np.float32),
          rng.uniform(-0.1, 0.1, (16, st.n_classes)).astype(np.float32)]
    eng = Engine(device="cpu")
    eng.register("plain", csr, weights=ws)
    eng.register("labels", csr, reorder="labels", labels=labels, weights=ws)
    assert eng.handle("labels").perm is not None
    got, want = eng.infer("labels", x), eng.infer("plain", x)
    assert got.shape == (csr.shape[0], st.n_classes)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- core surface ----
def test_core_exports_every_reference_name():
    missing = sorted(set(rc.__all__) - set(tc.__all__))
    assert not missing, f"repro_torch.core lacks {missing}"
    for name in tc.__all__:
        assert hasattr(tc, name), name


@pytest.mark.parametrize("r_block,kmax", [(8, 0), (8, 5), (4, 3)])
def test_empty_ragged_ell_matches_the_reference(r_block, kmax):
    got = tc.empty_ragged_ell(r_block, kmax, device="cpu")
    want = rc.empty_ragged_ell(r_block, kmax)
    assert type(got).__name__ == type(want).__name__ == "RaggedEll"
    for field in got._fields:
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(a.shape) == b.shape, field
        assert a.device.type == "cpu"
        assert str(a.dtype).split(".")[-1] == str(b.dtype), field
    assert got.n_units == 0 and got.r_block == r_block and got.kmax == kmax
    assert tc.ell_buckets(got, ()) == ()
    assert tc.empty_ragged_ell(device="cpu").r_block == 8


def test_empty_ragged_ell_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tc.empty_ragged_ell().cols.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.empty_ragged_ell()


def test_hybrid_spmm_ref_matches_the_reference_oracle():
    rng = np.random.default_rng(7)
    a = ((rng.random((70, 90)) < 0.1) * rng.standard_normal((70, 90))
         ).astype(np.float32)
    b = rng.standard_normal((90, 12)).astype(np.float32)
    want = np.asarray(rc.hybrid_spmm_ref(jnp.asarray(a), jnp.asarray(b)))
    got = tc.hybrid_spmm_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (70, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the oracle of the port's own SpMM, as the reference uses it
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    y = tc.hybrid_spmm(part, b, meta=meta, backend="torch", device="cpu")
    np.testing.assert_allclose(y.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
