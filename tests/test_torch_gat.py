"""The served GAT (``core/gat.py``): multi-head edge values in the three
engines, one softmax a row across them, ``Engine.register(...,
model="gat")``.

Everything is held against ``models/gat_ref.py``, the plain forward,
on seeded random weights over a small graph whose partition fills all
three engines and splits rows over two and three of them. CPU cases run
the kernels' plain versions: the engine's logits at G = 1, 2 and 4
(each member bitwise its own G = 1 call), the coefficients of a row
summing to 1 across the engines, class padding's rows coming out 0 and
finite, the multi-head plain versions against single-head runs on each
head's columns, the single-value plain versions unchanged, the
device segments of a layer in order, and ``register`` refusing a head
count the kernels are not built for. Tests marked ``cuda`` launch the
kernels on a card (the multi-head instances bitwise their plain
versions and the single-head launches, the edge-coefficient kernel
against its plain version, the served GAT against the reference); they
skip without one.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core.formats import (b_tiles_of, csr_from_scipy,
                                      segment_sum)
from repro_torch.core.gat import (GatLayer, _aggregate, attention_matrix,
                                  normalise, row_lists, split_rows)
from repro_torch.engine import Engine
from repro_torch.kernels import gat_coef, ops
from repro_torch.kernels.coo_spmm import coo_rows
from repro_torch.kernels.ell_spmm import ragged_ell_rows
from repro_torch.kernels.ref import (bsr_spmm_rows_ref, coo_rows_ref,
                                     gat_edge_coef_ref, gat_row_stats_ref,
                                     leaky_relu, ragged_ell_rows_ref)
from repro_torch.models.gat_ref import gat_forward_ref
from repro_torch.obs.device import DeviceChain

torch.set_num_threads(2)

N, F_IN = 300, 24
HEADS, WIDTH, OUT_HEADS, CLASSES = 4, 8, 6, 5
# float32 against the float64 reference, relative to the largest logit
REF_TOL = 2e-5


def assert_same_bits(a, b):
    """Bitwise equal (the sign of zero included), NaN payloads aside."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def make_graph(seed: int = 0, n: int = N) -> sp.csr_matrix:
    """A + I of a small SBM-like graph: a tight block (dense tiles), a
    loose block (ELL units) and scattered edges (COO), so rows split
    over two and three engines."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    a[:80, :80] = rng.random((80, 80)) < 0.9
    a[80:180, 80:180] = rng.random((100, 100)) < 0.15
    a += rng.random((n, n)) < 0.01
    return sp.csr_matrix(((a + np.eye(n)) > 0).astype(np.float32))


def glorot(rng, fan_in, fan_out):
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def make_layers(seed: int = 1):
    """The served model's structure at small widths: two concatenated
    layers of HEADS heads with ELU (a skip across the second) and an
    averaged output layer of OUT_HEADS heads."""
    rng = np.random.default_rng(seed)
    hf = HEADS * WIDTH
    return [
        GatLayer(glorot(rng, F_IN, hf), glorot(rng, HEADS, WIDTH),
                 glorot(rng, HEADS, WIDTH)),
        GatLayer(glorot(rng, hf, hf), glorot(rng, HEADS, WIDTH),
                 glorot(rng, HEADS, WIDTH), skip=True),
        GatLayer(glorot(rng, hf, OUT_HEADS * CLASSES),
                 glorot(rng, OUT_HEADS, CLASSES),
                 glorot(rng, OUT_HEADS, CLASSES), concat=False, elu=False),
    ]


def features(seed, n=N):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.random((n, F_IN)) < 0.3).astype(np.float32))


def logit_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def graph():
    return make_graph()


@pytest.fixture(scope="module")
def layers():
    return make_layers()


def _engine(graph, layers, device="cpu", **kw):
    eng = Engine(device=device, **kw)
    handle = eng.register("g", csr_from_scipy(graph), weights=layers,
                          model="gat")
    return eng, handle


def test_the_graph_fills_three_engines_and_splits_rows(graph, layers):
    _, h = _engine(graph, layers)
    m = h.meta
    assert m.n_dense_tiles > 0 and m.nnz_ell > 0 and m.nnz_coo > 0
    assert h.split_rows["two"] > 0 and h.split_rows["three"] > 0
    assert split_rows(h.part, h.padded_meta) == h.split_rows
    assert h.padded_meta.n_padded_rows > N     # class padding rows exist


@pytest.mark.parametrize("g", [1, 2, 4])
def test_engine_logits_match_reference_and_members_their_own_call(
        graph, layers, g):
    eng, _ = _engine(graph, layers)
    xs = [features(10 + k) for k in range(g)]
    got = eng.serve_group([("g", x) for x in xs])
    for x, y in zip(xs, got):
        want = gat_forward_ref(graph.indptr, graph.indices, x, layers,
                               dtype=torch.float64)
        assert y.shape == (N, CLASSES)
        assert logit_err(y, want) < REF_TOL
        assert_same_bits(y, eng.infer("g", x))


def test_torch_backend_gives_the_same_bits(graph, layers):
    eng, _ = _engine(graph, layers)
    plain, _ = _engine(graph, layers, backend="torch")
    x = features(3)
    assert_same_bits(eng.infer("g", x), plain.infer("g", x))


def _scores(h, heads, seed):
    """s [1, P, H] and t [1, P, H] of random magnitude, the grouped
    partition, plan and row lists of handle ``h``."""
    rng = np.random.default_rng(seed)
    p = h.padded_meta.n_padded_rows
    dev = h.part.dense.tiles.device
    s = torch.as_tensor(rng.standard_normal((1, p, heads)).astype(
        np.float32)).to(dev) * 3
    t = torch.as_tensor(rng.standard_normal((1, p, heads)).astype(
        np.float32)).to(dev) * 3
    part = type(h.part)(*(type(c)(*(a[None] for a in c)) for c in h.part))
    return s, t, part


@pytest.mark.parametrize("heads", [1, 4, 6])
def test_coefficients_of_a_row_sum_to_one_across_engines(graph, layers,
                                                         heads):
    eng, h = _engine(graph, layers)
    s, t, part = _scores(h, heads, heads)
    m, d = gat_row_stats_ref(h.rows.offsets, h.rows.cols, s, t, 0.2)
    coef = gat_edge_coef_ref(part, s, t, m, 0.2, h.padded_meta.tile)
    ones = torch.ones((1, h.padded_meta.n_padded_rows, heads))
    y = normalise(_aggregate(part, coef, ones, h.padded_meta, h.plan,
                             "cuda", None), d)[0]
    live = torch.as_tensor(np.diff(h.host_rows.offsets) > 0)
    torch.testing.assert_close(y[live], torch.ones_like(y[live]), rtol=0,
                               atol=2e-6)
    assert bool((y[~live] == 0).all())
    assert not bool(live[N:].any())


def test_padding_rows_come_out_zero_not_nan(graph, layers):
    eng, h = _engine(graph, layers)
    fn = eng.executors.gat(h.sclass, F_IN,
                           tuple(tuple(w.shape) for w in h.weights), h.gat)
    out = fn(h.part, eng._pad_x(h, features(4)), h.weights, h.plan, h.rows)
    assert out.shape == (h.padded_meta.n_padded_rows, CLASSES)
    assert bool(torch.isfinite(out).all())
    assert bool((out[N:] == 0).all())
    d = torch.zeros((1, 2, 2))
    assert bool((normalise(torch.zeros((1, 2, 4)), d) == 0).all())


def test_row_statistics_and_coefficients_plain(graph, layers):
    _, h = _engine(graph, layers)
    s, t, part = _scores(h, 4, 7)
    m, d = gat_row_stats_ref(h.rows.offsets, h.rows.cols, s, t, 0.2)
    offs = h.host_rows.offsets
    for i in (0, 5, 100, 250, N - 1, N + 3):
        nb = torch.as_tensor(h.host_rows.cols[offs[i]:offs[i + 1]]).long()
        if nb.numel() == 0:
            assert bool((m[0, i] == 0).all() and (d[0, i] == 0).all())
            continue
        e = leaky_relu(s[0, i] + t[0, nb], 0.2)
        assert torch.equal(m[0, i], e.max(0).values)
        torch.testing.assert_close(
            d[0, i].double(), torch.exp(e.double() - m[0, i].double()).sum(0),
            rtol=1e-6, atol=0)
    dense, ell, coo = gat_edge_coef_ref(part, s, t, m, 0.2,
                                        h.padded_meta.tile)
    assert bool(((ell != 0) <= (part.ell.vals != 0)[..., None]).all())
    assert bool(((coo != 0) <= (part.coo.vals != 0)[..., None]).all())
    assert bool((dense.permute(0, 1, 3, 4, 2)[part.dense.tiles == 0] == 0)
                .all())
    assert float(torch.cat([dense.flatten(), ell.flatten(),
                            coo.flatten()]).max()) <= 1.0


def _engines_of(h, heads, f, seed):
    """The three engines' operands of handle ``h`` with multi-head values
    and a random B of ``f`` columns."""
    rng = np.random.default_rng(seed)
    s, t, part = _scores(h, heads, seed)
    m, _ = gat_row_stats_ref(h.rows.offsets, h.rows.cols, s, t, 0.2)
    coef = gat_edge_coef_ref(part, s, t, m, 0.2, h.padded_meta.tile)
    b = torch.as_tensor(rng.standard_normal(
        (1, h.padded_meta.n_padded_rows, f)).astype(np.float32)).to(s.device)
    return part, coef, b


@pytest.mark.parametrize("heads,width", [(4, 8), (6, 5), (2, 3)])
def test_multi_head_plain_versions_are_single_head_runs(graph, layers, heads,
                                                        width):
    _, h = _engine(graph, layers)
    meta, plan = h.padded_meta, h.plan
    part, (dense, ell, coo), b = _engines_of(h, heads, heads * width, heads)
    bt = b_tiles_of(b, meta)
    p = meta.n_padded_rows
    yd = bsr_spmm_rows_ref(dense, part.dense.tile_col, bt, plan.dense)
    ye = ragged_ell_rows_ref(part.ell.cols, ell, part.ell.tile_col,
                             part.ell.unit_k, bt, plan.ell,
                             torch.zeros((1, p, heads * width)),
                             segments=tuple(meta.ell_segments))
    yc = coo_rows_ref(part.coo.cols, coo, b, plan.coo,
                      torch.zeros((1, p, heads * width)))
    for k in range(heads):
        cols = slice(k * width, (k + 1) * width)
        bk = b[..., cols].contiguous()
        btk = b_tiles_of(bk, meta)
        assert_same_bits(yd[..., cols], bsr_spmm_rows_ref(
            dense[:, :, k], part.dense.tile_col, btk, plan.dense))
        assert_same_bits(ye[..., cols], ragged_ell_rows_ref(
            part.ell.cols, ell[..., k], part.ell.tile_col, part.ell.unit_k,
            btk, plan.ell, torch.zeros((1, p, width)),
            segments=tuple(meta.ell_segments)))
        assert_same_bits(yc[..., cols], coo_rows_ref(
            part.coo.cols, coo[..., k], bk, plan.coo,
            torch.zeros((1, p, width))))


@pytest.mark.parametrize("heads", [1, 2, 8])
def test_register_refuses_head_counts_not_built(graph, heads):
    """The multi-head kernels are built for the served GAT's head counts
    (``_build.HEADS``) alone: ``register`` names them for any other."""
    rng = np.random.default_rng(heads)
    layer = GatLayer(glorot(rng, F_IN, heads * WIDTH),
                     glorot(rng, heads, WIDTH), glorot(rng, heads, WIDTH),
                     concat=False, elu=False)
    with pytest.raises(ValueError, match=r"built for \(4, 6\)"):
        Engine(device="cpu").register("g", csr_from_scipy(graph),
                                      weights=[layer], model="gat")


def test_single_value_plain_versions_unchanged(graph, layers):
    """The single-value plain versions (the kernels' bit-for-bit
    references) compute what they computed before multi-head values:
    the chains written out here."""
    _, h = _engine(graph, layers)
    meta, plan = h.padded_meta, h.plan
    part, _, b = _engines_of(h, 1, 9, 5)
    rng = np.random.default_rng(2)
    vals = part.ell.vals * torch.as_tensor(
        rng.standard_normal(part.ell.vals.shape).astype(np.float32))
    bt = b_tiles_of(b, meta)
    g, u, r, k = part.ell.cols.shape
    rows = bt[torch.zeros((g, u), dtype=torch.long), part.ell.tile_col.long()]
    acc = torch.zeros((g, u, r, 9))
    for kk in range(k):
        idx = part.ell.cols[..., kk].long()[..., None].expand(g, u, r, 9)
        v = torch.where((kk < part.ell.unit_k)[..., None], vals[..., kk],
                        torch.zeros(()))
        acc = acc + v[..., None].float() * torch.gather(rows, 2, idx)
    p = meta.n_padded_rows
    want = segment_sum(acc.reshape(g * u * r, 9), plan.ell).reshape(1, p, 9)
    got = ragged_ell_rows_ref(part.ell.cols, vals, part.ell.tile_col,
                              part.ell.unit_k, bt, plan.ell,
                              torch.zeros((1, p, 9)))
    assert_same_bits(got, torch.zeros((1, p, 9)) + want)
    cv = part.coo.vals * 3.0
    idx = part.coo.cols.long()[..., None].expand(-1, -1, 9)
    msgs = cv[..., None].float() * torch.gather(b, 1, idx)
    want = segment_sum(msgs.reshape(-1, 9), plan.coo).reshape(1, p, 9)
    assert_same_bits(coo_rows_ref(part.coo.cols, cv, b, plan.coo,
                                  torch.zeros((1, p, 9))),
                     torch.zeros((1, p, 9)) + want)


def test_a_layer_marks_its_segments_in_order(graph, layers):
    eng, h = _engine(graph, layers)
    fn = eng.executors.gat(h.sclass, F_IN,
                           tuple(tuple(w.shape) for w in h.weights), h.gat)
    chain = DeviceChain(lambda: 0.0, "cpu")
    fn(h.part, eng._pad_x(h, features(5)), h.weights, h.plan, h.rows,
       chain=chain)
    names = [(name, layer) for name, layer, _ in chain.marks[1:]]
    per = ["xw", "attn", "dense", "ell", "coo"]
    assert names == ([(s, 0) for s in per + ["out"]]
                     + [(s, 1) for s in per + ["out"]]
                     + [(s, 2) for s in per])


def test_register_and_group_keys(graph, layers):
    eng, h = _engine(graph, layers)
    eng.register("gcn", csr_from_scipy(graph),
                 weights=[np.ones((F_IN, 8), np.float32),
                          np.ones((8, 3), np.float32)])
    x = features(1)
    assert eng.group_key("g", x)[3:] == ("gat", h.gat)
    assert len(eng.group_key("gcn", x)) == 3
    assert h.gat.heads == (HEADS, HEADS, OUT_HEADS)
    assert h.gat.out_width == CLASSES
    with pytest.raises(ValueError, match="share one"):
        eng.serve_group([("g", x), ("gcn", x)])
    with pytest.raises(ValueError, match="unknown model"):
        eng.register("h", csr_from_scipy(graph), weights=layers,
                     model="gin")
    att = attention_matrix(layers[0].a_l, layers[0].a_r)
    b = torch.randn(3, HEADS * WIDTH)
    st = b @ att
    torch.testing.assert_close(
        st[:, :HEADS], (b.reshape(3, HEADS, WIDTH)
                        * torch.as_tensor(layers[0].a_l)).sum(-1))
    rl = row_lists(graph.indptr, graph.indices, N + 4)
    assert rl.offsets.shape == (N + 5,) and rl.offsets[-1] == graph.nnz


def test_register_span_carries_the_split_rows(graph, layers):
    from repro_torch.obs.trace import Tracer

    eng = Engine(device="cpu")
    tr = Tracer(capacity=1 << 10, sample_every=1)
    eng.attach_tracer(tr)
    h = eng.register("g", csr_from_scipy(graph), weights=layers,
                     model="gat")
    ends = [e for e in tr.events() if e["ph"] == "E" and e.get("args")
            and "split_rows_two" in e["args"]]
    assert len(ends) == 1
    assert ends[0]["args"] == {"split_rows_two": h.split_rows["two"],
                               "split_rows_three": h.split_rows["three"]}


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("heads,width", [(4, 256), (6, 41), (4, 3), (6, 16)])
def test_cuda_heads_kernels_bitwise(cuda_device, graph, layers, heads,
                                    width):
    """Each multi-head instance is bitwise its plain version (the ELL and
    COO engines) and bitwise the single-value kernel run on each head's
    columns (all three)."""
    eng, h = _engine(graph, layers, device=cuda_device)
    meta, plan = h.padded_meta, h.plan
    f = heads * width
    part, (dense, ell, coo), b = _engines_of(h, heads, f, width)
    p = meta.n_padded_rows
    ops.reset_launch_counts()
    yd = ops.dense_heads_matmul(part, dense, b, meta, plan)
    ye = ops.ell_heads_matmul(part, ell, b, meta, plan,
                              torch.zeros((1, p, f), device=cuda_device))
    yc = ops.coo_heads_matmul(part, coo, b, meta, plan,
                              torch.zeros((1, p, f), device=cuda_device))
    torch.cuda.synchronize()
    assert ops.launch_counts()["bsr_spmm"] == 1
    assert ops.launch_counts()["ragged_ell_spmm"] == 1
    assert ops.launch_counts()["coo_rows"] == 1
    bt = b_tiles_of(b, meta)
    assert_same_bits(ye, ragged_ell_rows_ref(
        part.ell.cols, ell, part.ell.tile_col, part.ell.unit_k, bt, plan.ell,
        torch.zeros((1, p, f), device=cuda_device),
        segments=tuple(meta.ell_segments)))
    assert_same_bits(yc, coo_rows_ref(part.coo.cols, coo, b, plan.coo,
                                      torch.zeros((1, p, f),
                                                  device=cuda_device)))
    for k in range(heads):
        cols = slice(k * width, (k + 1) * width)
        bk = b[..., cols].contiguous()
        zk = torch.zeros((1, p, width), device=cuda_device)
        one = type(part)(part.dense._replace(
            tiles=dense[:, :, k].contiguous()), part.ell, part.coo)
        assert_same_bits(yd[..., cols], ops.dense_tiles_matmul(
            one, bk, meta, plan))
        assert_same_bits(ye[..., cols], ragged_ell_rows(
            part.ell.cols, ell[..., k].contiguous(), part.ell.tile_col,
            part.ell.unit_k, b_tiles_of(bk, meta), plan.ell, zk.clone(),
            segments=tuple(meta.ell_segments), device=cuda_device))
        assert_same_bits(yc[..., cols], coo_rows(
            part.coo.cols, coo[..., k].contiguous(), b_tiles_of(bk, meta),
            plan.coo, plan.coo_rows, zk.clone(), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [4, 6])
def test_cuda_edge_coefficients_match_plain(cuda_device, graph, layers,
                                            heads):
    _, h = _engine(graph, layers, device=cuda_device)
    s, t, part = _scores(h, heads, heads + 20)
    gat_coef.reset_launch_counts()
    m, d = gat_coef.gat_row_stats(h.rows.offsets, h.rows.cols, s, t, 0.2,
                                  device=cuda_device)
    got = gat_coef.gat_edge_coef(part, s, t, m, 0.2, h.padded_meta.tile,
                                 device=cuda_device)
    torch.cuda.synchronize()
    assert gat_coef.launches == {"row_stats": 1, "edge_coef": 1}
    mw, dw = gat_row_stats_ref(h.rows.offsets, h.rows.cols, s, t, 0.2)
    assert_same_bits(m, mw)
    torch.testing.assert_close(d, dw, rtol=2e-6, atol=0)
    for g_, w_ in zip(got, gat_edge_coef_ref(part, s, t, m, 0.2,
                                             h.padded_meta.tile)):
        assert torch.equal(g_ == 0, w_ == 0)
        torch.testing.assert_close(g_, w_, rtol=3e-7, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4])
def test_cuda_served_gat_matches_reference(cuda_device, graph, layers, g):
    eng, h = _engine(graph, layers, device=cuda_device)
    xs = [features(30 + k).to(cuda_device) for k in range(g)]
    got = eng.serve_group([("g", x) for x in xs])
    for x, y in zip(xs, got):
        want = gat_forward_ref(graph.indptr, graph.indices, x, layers,
                               dtype=torch.float64)
        assert logit_err(y, want) < REF_TOL
        assert_same_bits(y, eng.infer("g", x))
    fn = eng.executors.gat(h.sclass, F_IN,
                           tuple(tuple(w.shape) for w in h.weights), h.gat)
    out = fn(h.part, eng._pad_x(h, xs[0]), h.weights, h.plan, h.rows)
    assert bool(torch.isfinite(out).all()) and bool((out[N:] == 0).all())
