"""The GAT's model module (``models/gat.py``), its configuration, cell and
readers: inputs from the seed, the float64 reference against the
program's plain forward and the TF32 control above the limit, the
request's FLOPs, a traced and an untraced run of the cell at a tiny size
on the CPU, the readers of the ``attn`` segments on a synthetic trace,
and a clean refusal by a program without GAT support."""
import json
import types

import pytest
import torch

from hgcn_bench import control, devtrace, gat_work, graphgen, spec
from hgcn_bench.cell import run_cell
from hgcn_bench.tests.test_hgcn_run import _tiny

CELL = "gat-reddit.batch"
PER_LAYER = ["attn_dev_ms", "gat_attn_roofline", "gat_agg_roofline",
             "stage_dev_ms.gat", "xw_dev_ms.gat", "dense_dev_ms.gat",
             "ell_dev_ms.gat", "coo_dev_ms.gat", "out_dev_ms.gat",
             "gcn_mfu_pct.gat", "register_s.gat", "reorder_s.gat",
             "partition_s.gat", "place_s.gat", "dispatch_host_ms.gat",
             "enqueue_host_ms.gat"]
# the twins of register's phases move setup_s, the rest requests_per_s
SETUP = {"register_s.gat", "reorder_s.gat", "partition_s.gat",
         "place_s.gat"}


def _small(cell):
    """The tiny cell with the GAT's heads kept and its widths cut, so the
    CPU runs it in seconds."""
    for lay in cell.config["model"]["layers"]:
        lay["head_width"] = 8 if lay["concat"] else 5
    cell.config["graph"]["n_classes"] = 5
    return cell


def test_the_cell_and_its_metrics_are_entries():
    bench = spec.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["config"] == "gat-reddit"
    assert cells[CELL]["traffic"] == "batch-g1" and cells[CELL]["chips"] == 1
    e2e, per = spec.metrics_of(bench, CELL)
    assert {m["name"] for m in e2e} == {"requests_per_s", "setup_s"}
    assert [m["name"] for m in per] == PER_LAYER
    assert all(m["moves"] == ("setup_s" if m["name"] in SETUP
                              else "requests_per_s") for m in per)
    cfg = spec.resolve(CELL).config
    with open(spec.ROOT / "hgcn_bench" / "configs" / "gcn-reddit.json") as f:
        gcn = json.load(f)
    assert cfg["graph"] == gcn["graph"]
    assert graphgen.graph_key(cfg["graph"]) == graphgen.graph_key(
        gcn["graph"])
    assert cfg["expected"] == gcn["expected"]
    assert [(lay["heads"], lay["head_width"]) for lay in
            cfg["model"]["layers"]] == [(4, 256), (4, 256), (6, 41)]


def test_inputs_come_from_the_seed():
    cell = _tiny(CELL)
    model = spec.model_of(cell.config)
    seed = 2 ** 31 + 5
    w1, p1 = model.make_inputs(torch, cell.config, cell.traffic, seed, 600,
                               "cpu")
    w2, p2 = model.make_inputs(torch, cell.config, cell.traffic, seed, 600,
                               "cpu")
    w3, _ = model.make_inputs(torch, cell.config, cell.traffic, seed + 1,
                              600, "cpu")
    assert torch.equal(p1, p2) and p1.shape == (8, 600, 32)
    shapes = [(32, 1024, 4, 256), (1024, 1024, 4, 256), (1024, 246, 6, 41)]
    for a, b, c, (fi, fo, h, fh) in zip(w1, w2, w3, shapes):
        for k in ("w", "a_l", "a_r"):
            assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert a["w"].shape == (fi, fo) and a["a_l"].shape == (h, fh)
        assert a["a_r"].shape == (h, fh)
    assert [lay["skip"] for lay in w1] == [False, True, False]
    assert [lay["concat"] for lay in w1] == [True, True, False]


def test_references_agree_with_the_programs_plain_forward(tmp_path):
    from repro_torch.core.gat import GatLayer
    from repro_torch.models.gat_ref import gat_forward_ref

    cell = _small(_tiny(CELL))
    model = spec.model_of(cell.config)
    atil, _, _ = graphgen.load_graph(cell.config["name"],
                                     cell.config["graph"], tmp_path)
    weights, pool = model.make_inputs(torch, cell.config, cell.traffic, 3,
                                      atil.shape[0], "cpu")
    got = model.reference(atil, "cpu", "float64").logits(pool[0], weights)
    layers = [GatLayer(**lay) for lay in weights]
    want = gat_forward_ref(atil.indptr, atil.indices, pool[0], layers,
                           dtype=torch.float64)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    tf32 = model.reference(atil, "cpu", "tf32").logits(pool[0], weights)
    assert tf32.dtype == torch.float32
    err = float((tf32.double() - got).abs().max() / got.abs().max())
    assert 1e-5 < err < 1e-1


def test_the_control_reads_above_the_limit(tmp_path):
    cell = _small(_tiny(CELL))
    rows = control.readings(cell, [1, 2], device="cpu", cache_dir=tmp_path)
    for seed, row in zip([1, 2], rows):
        assert row["seed"] == seed
        assert row["control_logit_err"] > row["limit"]


def test_request_flops_count_each_layer():
    cfg = spec.resolve(CELL).config
    n, nnz = cfg["graph"]["n_vertices"], cfg["expected"]["nnz_a_tilde"]
    flops = spec.model_of(cfg).request_flops(cfg, n, nnz)
    xw = 2.0 * n * (602 * 1024 + 1024 * 1024 + 1024 * 246)
    agg = 2.0 * nnz * (1024 + 1024 + 246)
    assert xw / 1e9 == pytest.approx(893.2, abs=0.1)
    assert agg / 1e9 == pytest.approx(54.0, abs=0.1)
    assert flops == xw + agg + 4.0 * n * (1024 + 1024 + 246) \
        + 5.0 * nnz * (4 + 4 + 6)
    assert 940e9 < flops < 960e9
    # the bounds the roofline shares take: the aggregation at its widths
    assert gat_work.layers(cfg) == [(4, 1024), (4, 1024), (6, 246)]
    assert gat_work.agg_bound_s(cfg, n, nnz) > gat_work.attn_bound_s(
        cfg, n, nnz) > 0


def test_a_traced_run_reports_the_gat_metrics(tmp_path):
    cell = _small(_tiny(CELL))
    out = run_cell(cell, 2 ** 31 + 9, 2.0, True, device="cpu",
                   cache_dir=tmp_path)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    # the CPU gives every span metric; the model step's share of the
    # card's peak is the card's alone
    assert set(got) == set(PER_LAYER) - {"gcn_mfu_pct.gat"}
    assert all(v["value"] >= 0 for v in got.values())
    assert got["attn_dev_ms"]["value"] > 0
    assert 0 < got["gat_attn_roofline"]["value"] <= 100
    assert 0 < got["gat_agg_roofline"]["value"] <= 100


def test_an_untraced_run_reports_throughput_and_setup(tmp_path):
    cell = _small(_tiny(CELL))
    out = run_cell(cell, 11, 1.5, False, device="cpu", cache_dir=tmp_path)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"requests_per_s", "setup_s"}
    assert out["checks"]["compared"]["value"] >= 1


class _Ring:
    """A tracer's ring holding given events."""

    def __init__(self, events):
        self._events = events

    def wrapped(self):
        return False

    def events(self):
        return self._events


def _span(sid, name, t0, t1, chain, live=1):
    args = {"chain": chain, "live": live, "enqueued": t0, "layer": 0}
    return [{"ph": "B", "sid": sid, "name": name, "cat": devtrace.SEGMENT_CAT,
             "ts": t0, "args": args},
            {"ph": "E", "sid": sid, "name": None, "cat": None, "ts": t1,
             "args": None}]


def _ctx(events):
    win = types.SimpleNamespace(t_start=0.0, t_end=10.0)
    return types.SimpleNamespace(tracer=_Ring(events), win=win, notes=[],
                                 sess=None)


def test_attn_reader_pairs_its_spans_of_the_windows_chains():
    read = spec.load_reader("attn_dev_ms")
    ev = (_span(1, "xw", 1.0, 1.5, 7) + _span(2, "attn", 1.5, 1.75, 7)
          + _span(3, "dense", 1.75, 2.0, 7)
          + _span(4, "attn", 2.0, 2.5, 7)
          # a chain enqueued after the window: not counted
          + _span(5, "xw", 11.0, 11.5, 8) + _span(6, "attn", 11.5, 12.0, 8))
    assert read(_ctx(ev)) == pytest.approx(750.0)
    # a program without the span gives nothing, and no error
    assert read(_ctx([e for e in ev if e.get("name") != "attn"
                      and e["sid"] not in (2, 4, 6)])) is None
    assert read(types.SimpleNamespace(tracer=None, notes=[])) is None


def test_a_program_without_gat_is_refused_at_once():
    model = spec.load_model("gat")

    class Engine:
        def register(self, name, csr, *, reorder=None, labels=None,
                     weights=None, part_meta=None):
            raise AssertionError("not reached")

    with pytest.raises(NotImplementedError, match="model='gat'"):
        model.register(Engine(), "g", None, {"reorder": None}, None, [])
