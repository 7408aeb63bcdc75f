"""The fixed-K ELL kernel with every bucket's products, their sum onto rows
and the add onto the dense engine's rows in one launch a layer
(``ell_spmm_rows``), the "fused"/"loop" dispatches as the port runs them.

On the CPU ``ell_spmm_rows`` runs its plain version ``ell_spmm_rows_ref``.
That is held bit for bit against the chain the per-K dispatches ran
before it: the per-bucket products (``ell_spmm_ref``),
``scatter_ell_partials`` (one reduction in the order of ``plan.ell`` for
"fused", one per bucket into a running buffer for "loop") and ``yd +
ye``. The inputs: class-padded cora and pubmed partitions (G = 1 and 4),
a partition whose padded rows are reached by units of several buckets,
negative weights and B with -0 entries (rows no bucket reaches are left
untouched, which equals ``yd + 0`` because the dense engine never writes
-0), and a non-finite B row read by a lane whose value is 0.

The whole SpMM with ``ell_dispatch="fused"``/``"loop"`` is held against
the reference's Pallas kernels in interpret mode within ``rtol=1e-4,
atol=1e-5`` (the same float32 products, added in another order by
another framework), and bit for bit against the port's "ragged".

Tests marked ``cuda`` launch the kernel; they skip without a card.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.formats import (CooResidual, DenseTiles,
                                      PartitionMeta, RaggedEll, TriPartition,
                                      b_tiles_of, ell_buckets, plan_to,
                                      reduction_plan, scatter_ell_partials,
                                      stack_plans)
from repro_torch.data.graphs import PAPER_DATASETS, make_paper_dataset
from repro_torch.engine import Engine
from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
from repro_torch.kernels import ops
from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_rows
from repro_torch.kernels.ref import ell_spmm_ref, ell_spmm_rows_ref

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

SPMM_TOL = dict(rtol=1e-4, atol=1e-5)
# class-padded paper graphs at a small scale: cora's class has two bands
# with rows, pubmed's three bands of which only the first has rows
PAPER = {"cora": 0.3, "pubmed": 0.2}


def assert_same_bits(a, b):
    """Bitwise equal (the sign of zero included), NaN payloads aside."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def folded(ell, bt, yd, plan, meta, device="cpu"):
    """The port's "fused"/"loop": one ``ell_spmm_rows`` call for every
    bucket, onto a copy of ``yd``."""
    return ell_spmm_rows(ell.cols, ell.vals, ell.tile_col, bt, plan.ell,
                         yd.clone(), plan.ell_bucket_k, device=device)


def parent_chain(ell, bt, yd, plan, meta, dispatch, per_band=ell_spmm_ref):
    """What "fused"/"loop" ran before: per-band products, their scatter
    onto rows (at once, or bucket by bucket), then ``yd + ye``."""
    g, f = bt.shape[0], bt.shape[-1]
    buckets = ell_buckets(ell, meta.ell_segments)
    prods = [per_band(bk.cols, bk.vals, bk.tile_col, bt) for bk in buckets]
    if dispatch == "fused":
        ye = scatter_ell_partials(
            ell.rows.reshape(g, -1),
            torch.cat(prods, dim=1).reshape(g, -1, f), meta, plan=plan.ell)
    else:
        ye = scatter_ell_partials([bk.rows.reshape(g, -1) for bk in buckets],
                                  [p.reshape(g, -1, f) for p in prods], meta)
    return yd + ye


# ------------------------------------------------------------- inputs ----
def _signed(a, seed=1):
    sign = np.where(np.random.default_rng(seed).random(a.shape) < 0.5, -1, 1)
    return (a * sign).astype(np.float32)


def paper_inputs(graph, g, f, scale=None, seed=0, device="cpu"):
    """The class-padded partition of a paper graph (at ``PAPER``'s small
    scale unless ``scale`` is given) with its weights' signs drawn at
    random, stacked ``g`` times, B with -0 entries, and ``yd`` from the
    port's dense engine. Returns (ell, bt, yd, plan, meta)."""
    csr, _, _, _ = make_paper_dataset(graph, scale=scale or PAPER[graph],
                                      seed=0)
    csr = csr._replace(data=_signed(csr.data))
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig(
        tile=64))
    part, meta = pad_to_class(part, meta, ClassRegistry().classify(part,
                                                                   meta))
    stacked = tc.partition_to(TriPartition(*(
        type(c)(*(np.stack([np.asarray(x)] * g) for x in c)) for c in part)),
        device)
    plan = plan_to(stack_plans([reduction_plan(part, meta)] * g), device)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((g, meta.n_cols, f)).astype(np.float32)
    b[rng.random(b.shape) < 0.2] = -0.0
    b = torch.from_numpy(b).to(device)
    yd = ops.dense_tiles_matmul(stacked, b, meta, plan)
    return stacked.ell, b_tiles_of(b, meta).contiguous(), yd, plan, meta


# (K, n_units) bands of the synthetic partition, widest first
SYNTH_BANDS = ((5, 3), (3, 4), (2, 2), (1, 3))


def synth_inputs(g=3, r=4, t=16, nct=3, nrt=2, f=7, n_rows=9, seed=0,
                 nonfinite=False):
    """A ragged ELL over ``SYNTH_BANDS`` whose unit rows land on a few of
    the padded rows, so most live rows are reached by several buckets and
    by several units of one bucket; some units have unit_k < K (zero
    lanes inside the bucket), some rows are sentinel.
    Negative weights, B with -0 entries, ``yd`` never -0. With
    ``nonfinite`` an inf sits in a B row that only a zero lane reads."""
    rng = np.random.default_rng(seed)
    u = sum(n for _, n in SYNTH_BANDS)
    kmax = SYNTH_BANDS[0][0]
    meta = PartitionMeta(nrt * t, nct * t, t, (1, 2, 3, 5), nrt, nct, 0, 0,
                         0, 0, 0, (0.5, 0.01), ell_segments=SYNTH_BANDS)
    p = meta.n_padded_rows
    unit_k = np.concatenate([
        np.where(rng.random((g, n)) < 0.7, k, rng.integers(0, k + 1, (g, n)))
        for k, n in SYNTH_BANDS], axis=1).astype(np.int32)
    live = np.arange(kmax) < unit_k[:, :, None, None]
    cols = (rng.integers(1, t, (g, u, r, kmax)) * live).astype(np.int32)
    vals = (rng.standard_normal((g, u, r, kmax)) * live).astype(np.float32)
    tcol = rng.integers(0, nct, (g, u)).astype(np.int32)
    pick = rng.choice(p, n_rows, replace=False)
    rows = pick[rng.integers(0, n_rows, (g, u, r))].astype(np.int32)
    rows[rng.random((g, u, r)) < 0.15] = meta.ell_sentinel_row
    b = rng.standard_normal((g, nct, t, f)).astype(np.float32)
    b[rng.random(b.shape) < 0.2] = -0.0
    if nonfinite:
        # col 0 is read only by zero lanes (live lanes use cols >= 1):
        # 0 * inf = NaN reaches the rows of units with a zero lane
        gi, ui = np.argwhere((unit_k > 0) & (unit_k < np.repeat(
            [k for k, _ in SYNTH_BANDS], [n for _, n in SYNTH_BANDS])))[0]
        b[gi, tcol[gi, ui], 0, :] = np.inf
    yd = rng.standard_normal((g, p, f)).astype(np.float32)
    yd[rng.random(yd.shape) < 0.1] = 0.0
    ell = RaggedEll(*(torch.from_numpy(np.ascontiguousarray(x))
                      for x in (cols, vals, rows, tcol, unit_k)))
    part = TriPartition(
        DenseTiles(np.zeros((g, 0, t, t), np.float32),
                   np.zeros((g, 0), np.int32), np.zeros((g, 0), np.int32)),
        RaggedEll(cols, vals, rows, tcol, unit_k),
        CooResidual(np.zeros((g, 0), np.int32), np.zeros((g, 0), np.int32),
                    np.zeros((g, 0), np.float32)))
    plan = plan_to(reduction_plan(part, meta), "cpu")
    return ell, torch.from_numpy(b), torch.from_numpy(yd), plan, meta


def shared_rows(ell, plan, meta) -> int:
    """Rows of member 0 that units of more than one bucket reach."""
    n = ell.rows.shape[-1]
    bucket = np.repeat(np.arange(len(meta.ell_segments)),
                       [c for _, c in meta.ell_segments])
    order = plan.ell.order.numpy()
    offsets = plan.ell.offsets.numpy()
    return sum(len(set(bucket[order[offsets[s]:offsets[s + 1]] // n])) > 1
               for s in range(meta.n_padded_rows))


# ------------------------------------------- the plain version, bitwise ----
@pytest.mark.parametrize("dispatch", ["fused", "loop"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("graph", sorted(PAPER))
def test_rows_ref_equals_parent_chain_at_paper_partitions(graph, g,
                                                          dispatch):
    for f in (16, PAPER_DATASETS[graph].n_classes):
        ell, bt, yd, plan, meta = paper_inputs(graph, g, f)
        assert len(meta.ell_segments) > 1
        assert not bool((torch.signbit(yd) & (yd == 0)).any())
        got = folded(ell, bt, yd, plan, meta)
        assert_same_bits(got, parent_chain(ell, bt, yd, plan, meta,
                                           dispatch))
        # rows no bucket reaches keep yd's bits
        hit = (plan.ell.lengths > 0).reshape(yd.shape[:2])
        assert bool((~hit).any()) and bool(hit.any())
        assert_same_bits(got[~hit], yd[~hit])


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_ref_equals_parent_chain_when_bands_share_rows(seed, dispatch):
    ell, bt, yd, plan, meta = synth_inputs(seed=seed)
    assert shared_rows(ell, plan, meta) > 0
    assert_same_bits(folded(ell, bt, yd, plan, meta),
                     parent_chain(ell, bt, yd, plan, meta, dispatch))


def test_rows_ref_propagates_a_nonfinite_b_row_read_by_a_zero_lane():
    ell, bt, yd, plan, meta = synth_inputs(seed=4, nonfinite=True)
    want = parent_chain(ell, bt, yd, plan, meta, "fused")
    got = folded(ell, bt, yd, plan, meta)
    assert bool(torch.isnan(got).any()) and not bool(torch.isnan(yd).any())
    assert_same_bits(got, want)
    assert_same_bits(got, parent_chain(ell, bt, yd, plan, meta, "loop"))


# ------------------------------------------------------------ wrappers ----
def test_rows_wrapper_checks_inputs_and_counts_no_cpu_launch():
    ell, bt, yd, plan, meta = synth_inputs()
    kb = plan.ell_bucket_k
    args = (ell.cols, ell.vals, ell.tile_col, bt, plan.ell)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="bucket_k"):
        ell_spmm_rows(*args, yd.clone(), kb[:-1], device="cpu")
    with pytest.raises(ValueError, match="bucket_k"):
        ell_spmm_rows(*args, yd.clone(), kb.long(), device="cpu")
    with pytest.raises(ValueError, match="out"):
        ell_spmm_rows(*args, yd[..., :-1], kb, device="cpu")
    with pytest.raises(ValueError, match="plan"):
        ell_spmm_rows(ell.cols[:, :-1], ell.vals[:, :-1],
                      ell.tile_col[:, :-1], bt, plan.ell, yd.clone(),
                      kb[:-1], device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ell_spmm_rows(ell.cols.long(), *args[1:], yd.clone(), kb,
                      device="cpu")
    out = yd.clone()
    assert ell_spmm_rows(*args, out, kb, device="cpu") is out
    assert ops.launch_counts()["ell_spmm"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ell_spmm_rows(*args, out, kb)


def test_ops_fused_and_loop_fold_the_sum_onto_the_dense_rows():
    """``ops.ell_matmul`` on "fused"/"loop": the bucket rows onto ``yd``
    in place, equal to the parent chain bit for bit, with no launch
    counted on the CPU; a plan without its bucket table is refused."""
    ell, bt, yd, plan, meta = paper_inputs("cora", 2, 9)
    part = TriPartition(DenseTiles(None, None, None), ell,
                        CooResidual(None, None, None))
    b = bt.reshape(bt.shape[0], -1, bt.shape[-1])
    for d in ("fused", "loop"):
        want = parent_chain(ell, bt, yd, plan, meta, d)
        ops.reset_launch_counts()
        out = yd.clone()
        assert ops.ell_matmul(part, b, meta, plan, out, dispatch=d) is out
        assert_same_bits(out, want)
        assert ops.launch_counts()["ell_spmm"] == 0
    with pytest.raises(ValueError, match="bucket table"):
        ops.ell_matmul(part, b, meta, plan._replace(ell_bucket_k=None), yd,
                       dispatch="fused")


# ------------------------------------------------ against the reference ----
def _graph(kind):
    if kind == "hetero":
        return make_heterogeneous_matrix(300, seed=3)
    csr, _, _, _ = make_paper_dataset("cora", scale=0.2, seed=0)
    a = np.zeros(csr.shape, np.float32)
    for i in range(csr.shape[0]):
        idx = csr.indices[csr.indptr[i]:csr.indptr[i + 1]]
        a[i, idx] = csr.data[csr.indptr[i]:csr.indptr[i + 1]]
    return _signed(a)


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
@pytest.mark.parametrize("kind", ["hetero", "cora_signed"])
def test_dispatches_match_the_pallas_reference(kind, dispatch):
    import jax.numpy as jnp
    import repro.core as rc
    a = _graph(kind)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    ref_part, ref_meta, _ = rc.analyze_and_partition(
        rc.csr_from_dense(a), rc.PartitionConfig(tile=64))
    assert len(meta.ell_segments) > 1
    b = np.random.default_rng(4).standard_normal((a.shape[1], 12)).astype(
        np.float32)
    got = tc.hybrid_spmm(part, b, meta=meta, backend="cuda",
                         ell_dispatch=dispatch, device="cpu")
    want = np.asarray(rc.hybrid_spmm(ref_part, jnp.asarray(b), meta=ref_meta,
                                     backend="pallas", ell_dispatch=dispatch))
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)
    ragged = tc.hybrid_spmm(part, b, meta=meta, backend="cuda", device="cpu")
    assert torch.equal(got, ragged)


def test_engine_dispatches_give_the_same_logits_bit_for_bit():
    csr, x, _, st = make_paper_dataset("cora", scale=0.3, seed=0)
    rng = np.random.default_rng(0)
    ws = [rng.uniform(-0.1, 0.1, (st.n_features, 16)).astype(np.float32),
          rng.uniform(-0.1, 0.1, (16, st.n_classes)).astype(np.float32)]
    xs = [x, (rng.random(x.shape) < 0.05).astype(np.float32)]
    outs = {}
    for d in ("ragged", "fused", "loop"):
        eng = Engine(device="cpu", ell_dispatch=d)
        eng.register("cora", csr, weights=ws)
        h = eng.handle("cora")
        np.testing.assert_array_equal(h.plan.ell_bucket_k.numpy(),
                                      np.repeat(*zip(*h.sclass.bands)))
        outs[d] = [eng.infer("cora", x) for x in xs] + eng.serve_group(
            [("cora", x) for x in xs])
    for d in ("fused", "loop"):
        for a, b in zip(outs[d], outs["ragged"]):
            assert torch.equal(a, b)


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("graph", ["cora", "pubmed"])
def test_cuda_band_rows_bitwise_at_paper_shapes(cuda_device, graph, g):
    """At the class-padded partitions of cora and pubmed (full size), F =
    128 and the class count: one launch for every bucket, equal to the
    plain version and to the per-unit kernel + ``scatter_ell_partials`` +
    add bit for bit, on both dispatches."""
    for f in (128, PAPER_DATASETS[graph].n_classes):
        ell, bt, yd, plan, meta = paper_inputs(graph, g, f, scale=1.0,
                                               device=cuda_device)
        ops.reset_launch_counts()
        got = folded(ell, bt, yd, plan, meta, device=cuda_device)
        assert ops.launch_counts()["ell_spmm"] == 1
        assert ops.launch_counts()["ragged_ell_spmm"] == 0
        assert_same_bits(got, folded(ell, bt, yd, plan, meta,
                                     device=cuda_device))      # repeats
        want = ell_spmm_rows_ref(ell.cols, ell.vals, ell.tile_col, bt,
                                 plan.ell, yd.clone(), plan.ell_bucket_k)
        assert_same_bits(got, want)
        for d in ("fused", "loop"):
            assert_same_bits(got, parent_chain(
                ell, bt, yd, plan, meta, d,
                per_band=lambda *a: ell_spmm(*a, device=cuda_device)))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [7, 16, 128, 130])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_cuda_band_rows_carry_case_bitwise(cuda_device, f, nonfinite):
    """Rows reached by several buckets, each summed in registers across
    the buckets in one launch."""
    ell, bt, yd, plan, meta = synth_inputs(f=f, seed=f, nonfinite=nonfinite)
    want = folded(ell, bt, yd, plan, meta)
    dev = cuda_device
    ell = RaggedEll(*(x.to(dev) for x in ell))
    plan = plan_to(plan, dev)
    ops.reset_launch_counts()
    got = folded(ell, bt.to(dev), yd.to(dev), plan, meta, device=dev)
    assert ops.launch_counts()["ell_spmm"] == 1
    assert_same_bits(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 7])
def test_cuda_band_rows_at_the_labels_training_partition(cuda_device, f):
    """cora reordered by labels, not padded to a class (the partition
    training differentiates through): one bucket per K run, a dozen and
    more of them, in one launch, bit for bit the per-bucket chains and
    the ragged kernel."""
    from repro_torch.core.reorder import reorder
    dev = cuda_device
    csr, _, _, _ = make_paper_dataset("cora", scale=1.0, seed=0)
    csr = reorder(csr, "labels", labels=make_paper_dataset.last_labels)[0]
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig(
        tile=64))
    assert len(meta.ell_segments) > 8
    placed = tc.partition_to(TriPartition(*(
        type(c)(*(np.asarray(x)[None] for x in c)) for c in part)), dev)
    plan = plan_to(reduction_plan(part, meta), dev)
    b = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (1, meta.n_cols, f)).astype(np.float32)).to(dev)
    bt = b_tiles_of(b, meta).contiguous()
    yd = ops.dense_tiles_matmul(placed, b, meta, plan)
    ops.reset_launch_counts()
    got = folded(placed.ell, bt, yd, plan, meta, device=dev)
    assert ops.launch_counts()["ell_spmm"] == 1
    for d in ("fused", "loop"):
        assert_same_bits(got, parent_chain(
            placed.ell, bt, yd, plan, meta, d,
            per_band=lambda *a: ell_spmm(*a, device=dev)))
    assert_same_bits(got, ops.ell_matmul(placed, b, meta, plan, yd.clone()))
