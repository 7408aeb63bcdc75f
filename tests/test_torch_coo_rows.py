"""The flexible engine's COO row kernel (``coo_rows``): each row's messages
summed in plan order and added onto the dense + ELL rows, in one launch
a layer.

On the CPU the wrapper runs its plain version ``coo_rows_ref``, which is
held bit for bit against the unfused chain on the ``torch`` backend
(``hybrid_spmm.coo_matmul``, then ``y + coo``): group sizes 1 and 4, the
four (vals, B) type pairs, class padding's duplicate (0, 0, +0) triples,
an empty COO, rows of one entry and rows past the kernel's long-row
threshold. The launch order the plan carries (``RowOrder``), the
wrapper's checks and counters and the launch contract are tested here
too.

Tests marked ``cuda`` launch the kernel on a card (a row-length mix like
the Reddit-sized graph's, one row of 11 308 entries among them; inside a
captured CUDA graph; a NaN in B; the served GCN forward and its gradient
against the unfused COO ops); they skip without one.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.analysis.static.kernel_pass import check_contract
from repro_torch.core.hybrid_spmm import _hybrid, coo_matmul
from repro_torch.core.formats import (CooResidual, DenseTiles, PartitionMeta,
                                      RowOrder, TriPartition, b_tiles_of,
                                      plan_to, reduction_plan, row_order,
                                      segment_live, stack_plans)
from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
from repro_torch.kernels import coo_spmm, ops
from repro_torch.kernels.coo_spmm import (coo_rows, coo_rows_contract,
                                          coo_rows_cost, launch_shape)
from repro_torch.kernels.ref import coo_rows_ref

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

TYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]
TYPE_IDS = ["f32", "f32_bf16", "bf16_bf16", "bf16_f32"]
# a row length past the long-row length of every launch here
LONG = 512


def assert_same_bits(a, b):
    """Bitwise equal (the sign of zero included), NaN payloads aside."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _meta(t, nrt, nct, nnz):
    return PartitionMeta(nrt * t, nct * t, t, (), nrt, nct, 0, 0, 0, 0, nnz,
                         (0.5, 0.01))


# Each case: entries a live row (a member's rows are drawn at random),
# and how many class-padding (0, 0, +0) triples follow the entries.
CASES = {
    "mixed": ([1, 2, 2, 3, 5, 7, 7, 9, 13, 31, 46, 100], 0),
    "class_padded": ([1, 3, 4, 7, 8, 12, 40], 37),
    "single_entries": ([1] * 40, 0),
    "long_rows": ([LONG + 37, 2 * LONG, LONG, LONG - 1, 1, 5, 9], 5),
    "empty": ([], 0),
}


def coo_member(rng, lengths, pad, p, n_cols):
    """One member's COO leaves (rows, cols, vals): ``lengths`` entries on
    distinct random rows, in shuffled order, then ``pad`` padding
    triples."""
    rows = np.repeat(rng.choice(p, len(lengths), replace=False),
                     lengths).astype(np.int32)
    cols = rng.integers(0, n_cols, rows.size).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[rng.random(rows.size) < 0.05] = 0.0
    perm = rng.permutation(rows.size)
    z = np.zeros(pad, np.int32)
    return (np.concatenate([rows[perm], z]), np.concatenate([cols[perm], z]),
            np.concatenate([vals[perm], np.zeros(pad, np.float32)]))


def coo_inputs(case, g=1, f=9, t=16, nrt=64, nct=48, seed=0,
               dtypes=TYPES[0]):
    """A grouped COO-only partition, its meta, the stacked plan on the
    CPU, B [G, nct*T, F] and the rows to add onto [G, P, F]."""
    lengths, pad = CASES[case]
    rng = np.random.default_rng(seed)
    p, n_cols = nrt * t, nct * t - 5        # B's last rows meet no entry
    members = [coo_member(rng, lengths, pad, p, n_cols) for _ in range(g)]
    nnz = members[0][0].size
    meta = _meta(t, nrt, nct, nnz)
    vt, bt = dtypes

    def part_of(rows, cols, vals):
        return TriPartition(
            DenseTiles(np.zeros((0, t, t), np.float32),
                       np.zeros(0, np.int32), np.zeros(0, np.int32)),
            tc.empty_ragged_ell(device="cpu"),
            CooResidual(torch.from_numpy(rows), torch.from_numpy(cols),
                        torch.from_numpy(vals)))

    plan = plan_to(stack_plans([reduction_plan(part_of(*m), meta)
                                for m in members]), "cpu")
    part = TriPartition(
        DenseTiles(torch.zeros((g, 0, t, t)), torch.zeros((g, 0),
                                                          dtype=torch.int32),
                   torch.zeros((g, 0), dtype=torch.int32)),
        tc.RaggedEll(*(a[None].expand(g, *a.shape) for a in
                       tc.empty_ragged_ell(device="cpu"))),
        CooResidual(*(torch.from_numpy(np.stack(a)) for a in zip(*members))))
    part = part._replace(coo=part.coo._replace(vals=part.coo.vals.to(vt)))
    b = torch.from_numpy(rng.standard_normal((g, nct * t, f)).astype(
        np.float32)).to(bt)
    y = torch.from_numpy(rng.standard_normal((g, p, f)).astype(np.float32))
    y[torch.rand(y.shape, generator=torch.Generator().manual_seed(seed))
      < 0.1] = 0.0
    return part, meta, plan, b, y


def unfused(part, b, meta, plan, y):
    """The unfused chain, which the ``torch`` backend runs:
    ``y + coo_matmul``."""
    return y + coo_matmul(part, b, meta, plan)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtypes", TYPES, ids=TYPE_IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_unfused_chain_bitwise(case, dtypes, g):
    part, meta, plan, b, y = coo_inputs(case, g=g, dtypes=dtypes, seed=g)
    want = unfused(part, b, meta, plan, y)
    out = y.clone()
    got = coo_rows(part.coo.cols, part.coo.vals, b_tiles_of(b, meta),
                   plan.coo, plan.coo_rows, out, device="cpu")
    assert got is out                                       # in place
    assert_same_bits(got, want)
    assert_same_bits(coo_rows_ref(part.coo.cols, part.coo.vals, b, plan.coo,
                                  y.clone()), want)
    # rows without an entry keep their bits
    empty = (plan.coo.lengths == 0).reshape(y.shape[:2])
    assert_same_bits(got[empty], y[empty])
    # the engine's entry point: the same bits, through b_tiles_of
    assert_same_bits(ops.coo_matmul(part, b, meta, plan, y.clone()), want)


def test_long_row_length_follows_the_launch_size():
    """A row is long from the entries a resident row group would walk
    (entries / 4096), down to a power of two, at least 32: at the
    benchmark's Reddit- and Flickr-sized groups and members."""
    long_row = coo_spmm.long_row
    assert [long_row(n) for n in (8704160, 2176040, 551932, 137983)] == [
        2048, 512, 128, 32]
    assert long_row(0) == long_row(1) == long_row(131071) == 32
    assert long_row(131072) == 32 and long_row(262144) == 64


def test_long_and_single_rows_are_what_the_cases_say():
    _, _, plan, _, _ = coo_inputs("long_rows", g=4)
    assert coo_spmm.long_row(plan.coo.order.numel()) <= LONG
    n_long = plan.coo_rows.n_at_least(LONG)
    # the plan drops a +0 entry that repeats another's (row, col)
    assert n_long == int((plan.coo.lengths >= LONG).sum()) >= 4 * 2
    assert (plan.coo.lengths[plan.coo_rows.rows[:n_long]] >= LONG).all()
    _, _, plan, _, _ = coo_inputs("single_entries", g=1)
    assert int(plan.coo.lengths.max()) == 1
    assert plan.coo_rows.at_least == (40,)
    # class padding: the first triple is kept, its duplicates dropped
    part, _, plan, _, _ = coo_inputs("class_padded", g=1)
    assert plan.coo.order.numel() == sum(CASES["class_padded"][0]) + 1
    assert part.coo.vals.shape[-1] == plan.coo.order.numel() + 36


def test_empty_coo_launches_nothing_and_returns_y():
    part, meta, plan, b, y = coo_inputs("empty", g=2)
    assert part.coo.vals.shape[-1] == 0
    out = y.clone()
    assert ops.coo_matmul(part, b, meta, plan, out) is out
    assert_same_bits(out, y)


@pytest.mark.parametrize("g", [1, 4])
def test_ops_coo_matmul_on_a_class_padded_partition(g):
    """A heterogeneous graph padded to its shape class (duplicate padding
    triples in COO), stacked g times: ``ops.coo_matmul`` is the unfused
    ``y + coo_matmul`` bit for bit, and ``_hybrid`` on the ``cuda``
    backend (plain versions on the CPU) is the ``torch`` backend's."""
    a = make_heterogeneous_matrix(300, seed=3)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    sc = ClassRegistry().classify(part, meta)
    padded, pmeta = pad_to_class(part, meta, sc)
    assert pmeta.nnz_coo < padded.coo.vals.shape[0]          # padding
    host = reduction_plan(padded, pmeta)
    plan = plan_to(stack_plans([host] * g), "cpu")
    gpart = tc.partition_to(padded, "cpu")
    gpart = TriPartition(*(type(c)(*(torch.stack([x] * g) for x in c))
                           for c in gpart))
    rng = np.random.default_rng(g)
    b = torch.from_numpy(rng.standard_normal(
        (g, pmeta.n_cols, 16)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (g, pmeta.n_padded_rows, 16)).astype(np.float32))
    assert_same_bits(ops.coo_matmul(gpart, b, pmeta, plan, y.clone()),
                     unfused(gpart, b, pmeta, plan, y))
    assert_same_bits(_hybrid(gpart, b, pmeta, plan, "cuda", "ragged"),
                     _hybrid(gpart, b, pmeta, plan, "torch", "ragged"))


def test_row_order_is_longest_first_and_live_stays_ascending():
    lengths = np.array([0, 3, 1, 0, 3, 9, 1, 2, 0, 16])
    order = row_order(lengths)
    assert order.rows.tolist() == [9, 5, 1, 4, 7, 2, 6]     # ties by id
    assert order.at_least == (7, 5, 2, 2, 1)
    assert [order.n_at_least(n) for n in (1, 2, 4, 8, 16, 32)] == [
        7, 5, 2, 2, 1, 0]
    with pytest.raises(ValueError, match="power of two"):
        order.n_at_least(3)
    none = row_order(np.zeros(5, np.int64))
    assert none.rows.size == 0 and none.at_least == ()
    assert isinstance(none, RowOrder) and none.n_at_least(512) == 0
    # the stacked plan: one launch order over the group; live ascending
    _, _, plan, _, _ = coo_inputs("mixed", g=3)
    lengths = plan.coo.lengths.numpy()
    rows = plan.coo_rows.rows.numpy()
    assert sorted(rows.tolist()) == np.flatnonzero(lengths).tolist()
    assert (np.diff(lengths[rows]) <= 0).all()
    live = plan.coo.live.numpy()
    assert (live == segment_live(lengths.reshape(3, -1))).all()
    assert all((np.diff(m[m >= 0]) > 0).all() for m in live)


def test_wrapper_checks_inputs_and_counts():
    part, meta, plan, b, y = coo_inputs("mixed", g=2)
    args = (part.coo.cols, part.coo.vals, b_tiles_of(b, meta), plan.coo,
            plan.coo_rows)
    bad = [
        (part.coo.cols.long(),) + args[1:],
        (part.coo.cols, part.coo.vals.double()) + args[2:],
        (part.coo.cols[:1],) + args[1:],
        args[:2] + (b_tiles_of(b.double(), meta),) + args[3:],
    ]
    for a in bad:
        with pytest.raises(ValueError, match="coo_rows"):
            coo_rows(*a, y.clone(), device="cpu")
    with pytest.raises(ValueError, match="coo_rows"):
        coo_rows(*args, y[:, 1:].clone(), device="cpu")
    with pytest.raises(ValueError, match="coo_rows"):
        coo_rows(*args, y.double(), device="cpu")
    ops.reset_launch_counts()
    ops.reset_entry_counts()
    coo_rows(*args, y.clone(), device="cpu")
    coo_rows(*args[:4], None, y.clone(), device="cpu")     # no order: CPU
    assert ops.entry_counts()["coo_rows"] == 2
    # CPU tensors take the plain version: nothing is launched
    assert ops.launch_counts()["coo_rows"] == 0
    assert ops.launch_counts_by_dtype()["coo_rows"] == {"float32": 0,
                                                        "bfloat16": 0}


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    part, meta, plan, b, y = coo_inputs("mixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        coo_rows(part.coo.cols, part.coo.vals, b_tiles_of(b, meta),
                 plan.coo, plan.coo_rows, y)


@pytest.mark.parametrize("f,shape", [(7, (8, 1, 1)), (16, (16, 1, 1)),
                                     (41, (32, 1, 2)), (128, (32, 4, 1)),
                                     (30, (32, 1, 1))])
def test_contract_legal_and_spills_rejected(f, shape):
    assert launch_shape(f) == shape
    assert launch_shape(128, aligned=False) == (32, 1, 2)
    for vt, bt in TYPES:
        c = coo_rows_contract(4, 2720, 2334, 2621, f, n_live=9304,
                              n_long=39, vals_dtype=vt, b_dtype=bt)
        assert c["instance"][:3] == shape
        assert c["static_smem"] <= 48 * 1024
        last = (np.full((4, 2720), 2333, np.int32),)

        def log(stores):
            name = f"_ZN8coo_rows15{c['ptxas_name']}EvNS_7EntriesIT2_EE"
            return (f"ptxas info    : Compiling entry function '{name}' for "
                    f"'sm_90a'\n    {stores} bytes stack frame, {stores} "
                    f"bytes spill stores, {stores} bytes spill loads\n"
                    "ptxas info    : Used 72 registers, used 1 barriers")

        assert check_contract(c, scalar_args=last, ptxas_log=log(0)) == []
        rules = {f.rule for f in check_contract(c, scalar_args=last,
                                                ptxas_log=log(8))}
        assert rules == {"registers"}
        # an entry past B's rows
        rules = {f.rule for f in check_contract(
            c, scalar_args=(last[0] + 1,), ptxas_log=log(0))}
        assert rules == {"index-bounds"}


def test_cost_counts_distinct_b_rows():
    part, meta, plan, b, y = coo_inputs("mixed", g=2, f=8)
    cost = coo_rows_cost(part.coo.cols, plan.coo, 8)
    e = plan.coo.order.numel()
    live = int((plan.coo.lengths > 0).sum())
    order = plan.coo.order.numpy()
    nnz = part.coo.cols.shape[-1]
    rows = {(int(o) // nnz, int(part.coo.cols.reshape(-1)[o]))
            for o in order}
    assert cost["hbm_bytes"] == e * 16 + len(rows) * 32 + live * (24 + 64)
    assert cost["flops"] == 2 * e * 8 + live * 8


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


def reddit_mix(g, f, dtypes, seed=0, p=60000, n_b=50000):
    """A COO-only partition whose row lengths follow the Reddit-sized
    graph's (a median of about 7, a tail of rows in the hundreds and
    thousands, the longest 11 308 entries), on the CPU; as
    ``coo_inputs``."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.geometric(0.12, 30000), 255).tolist() + [
        11308, 8213, 2049, 1024, 600, 511, 256]
    t = 64
    nrt, nct = -(-p // t), -(-n_b // t)
    members = [coo_member(rng, lengths, 21, nrt * t, n_b) for _ in range(g)]
    meta = _meta(t, nrt, nct, members[0][0].size)
    plans, leaves = [], []
    for m in members:
        part = TriPartition(
            DenseTiles(np.zeros((0, t, t), np.float32), np.zeros(0, np.int32),
                       np.zeros(0, np.int32)),
            tc.empty_ragged_ell(device="cpu"),
            CooResidual(*(torch.from_numpy(x) for x in m)))
        plans.append(reduction_plan(part, meta))
        leaves.append(m)
    cols, vals = (torch.from_numpy(np.stack([m[i] for m in leaves]))
                  for i in (1, 2))
    b = torch.from_numpy(rng.standard_normal((g, nct * t, f)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal((g, nrt * t, f)).astype(
        np.float32))
    vt, bt = dtypes
    return cols, vals.to(vt), b.to(bt), y, stack_plans(plans), meta


def _on(dev, cols, vals, b, y, plan, meta):
    plan = plan_to(plan, dev)
    return (cols.to(dev), vals.to(dev), b_tiles_of(b.to(dev), meta),
            y.to(dev), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", TYPES, ids=TYPE_IDS)
@pytest.mark.parametrize("f,g", [(128, 1), (41, 2), (7, 1), (128, 2)])
def test_cuda_kernel_bitwise_plain_on_a_reddit_mix(cuda_device, f, g,
                                                   dtypes, monkeypatch):
    cols, vals, b, y, plan, meta = reddit_mix(g, f, dtypes, seed=f + g)
    cd, vd, bd, yd, pd = _on(cuda_device, cols, vals, b, y, plan, meta)
    assert pd.coo_rows.n_at_least(
        coo_spmm.long_row(pd.coo.order.numel())) >= 4 * g
    want = coo_rows_ref(cd, vd, bd.reshape(g, -1, f), pd.coo, yd.clone())
    ops.reset_launch_counts()
    got = coo_rows(cd, vd, bd, pd.coo, pd.coo_rows, yd.clone())
    torch.cuda.synchronize()
    assert ops.launch_counts()["coo_rows"] == 1
    assert_same_bits(got, want)
    # every row on the short path, and every row on the long one: the
    # same bits
    for n in (2 ** 20, 1):
        monkeypatch.setattr(coo_spmm, "long_row", lambda entries: n)
        again = coo_rows(cd, vd, bd, pd.coo, pd.coo_rows, yd.clone())
        assert_same_bits(again, want)


@pytest.mark.cuda
def test_cuda_kernel_in_a_captured_graph(cuda_device):
    cols, vals, b, y, plan, meta = reddit_mix(2, 128, TYPES[0], seed=5)
    cd, vd, bd, yd, pd = _on(cuda_device, cols, vals, b, y, plan, meta)
    want = coo_rows_ref(cd, vd, bd.reshape(2, -1, 128), pd.coo, yd.clone())
    out = yd.clone()
    coo_rows(cd, vd, bd, pd.coo, pd.coo_rows, out)          # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        coo_rows(cd, vd, bd, pd.coo, pd.coo_rows, out)
    for _ in range(2):
        out.copy_(yd)
        graph.replay()
        torch.cuda.synchronize()
        assert_same_bits(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 41, 7])
def test_cuda_nan_in_b_propagates_as_plain(cuda_device, f):
    cols, vals, b, y, plan, meta = reddit_mix(1, f, TYPES[0], seed=7)
    b[0, int(cols[0, 0])] = float("nan")                      # a short row
    long_row = int(plan.coo_rows.rows[0])
    first = int(plan.coo.order[plan.coo.offsets[long_row] + 300])
    b[0, int(cols.reshape(-1)[first]), 1] = float("inf")     # a long row
    cd, vd, bd, yd, pd = _on(cuda_device, cols, vals, b, y, plan, meta)
    want = coo_rows_ref(cd, vd, bd.reshape(1, -1, f), pd.coo, yd.clone())
    got = coo_rows(cd, vd, bd, pd.coo, pd.coo_rows, yd.clone())
    assert bool(torch.isnan(want).any())
    assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_gcn_forward_bits_unchanged(cuda_device, g, monkeypatch):
    """The served forward with the kernel is bitwise the same forward with
    the unfused COO ops (``y + hybrid_spmm.coo_matmul`` on the same CUDA
    tensors), its gradient too; two kernel launches a forward."""
    from repro_torch.data.graphs import make_paper_dataset
    csr, x, _, _ = make_paper_dataset("pubmed", scale=1.0, seed=0)
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig())
    assert meta.nnz_coo > 0
    rng = np.random.default_rng(g)
    ws = [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(
        np.float32)).to(cuda_device) for s in ((x.shape[1], 128),
                                               (128, 3))]
    xs = torch.from_numpy(np.stack([x] * g)).to(cuda_device)
    gpart = tc.partition_to(part, cuda_device)
    gpart = TriPartition(*(type(c)(*(torch.stack([a] * g) for a in c))
                           for c in gpart))
    plan = plan_to(stack_plans([reduction_plan(part, meta)] * g),
                   cuda_device)

    def forward(xin, weights):
        return tc.gcn_forward(gpart, xin, [w[None] for w in weights],
                              meta=meta, plan=plan, device=cuda_device)

    ops.reset_launch_counts()
    y_new = forward(xs, ws)
    torch.cuda.synchronize()
    assert ops.launch_counts()["coo_rows"] == 2
    w_new = [w.clone().requires_grad_() for w in ws]
    grads_new = torch.autograd.grad(forward(xs, w_new).sum(), w_new)

    def unfused_ops(part, b, meta, plan, y):
        return y + coo_matmul(part, b, meta, plan)
    monkeypatch.setattr(ops, "coo_matmul", unfused_ops)
    ops.reset_launch_counts()
    y_old = forward(xs, ws)
    assert ops.launch_counts()["coo_rows"] == 0
    w_old = [w.clone().requires_grad_() for w in ws]
    grads_old = torch.autograd.grad(forward(xs, w_old).sum(), w_old)
    assert_same_bits(y_new, y_old)
    for a, b in zip(grads_new, grads_old):
        assert_same_bits(a, b)
