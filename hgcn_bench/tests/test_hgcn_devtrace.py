"""The readers of the program's own spans (``devtrace.py``): a traced
run at a tiny size on the CPU reports every one that the CPU can give,
and a program without the spans (or a ring that wrapped) gives none of
them, without raising."""
import math
import re
import types

import pytest

from hgcn_bench import devtrace, spec
from hgcn_bench.cell import run_cell
from hgcn_bench.tests.test_hgcn_run import _tiny

DEV = [f"{s}_dev_ms" for s in devtrace.SEGMENTS]
PHASES = ["reorder_s", "partition_s", "place_s"]
HOST = ["enqueue_host_ms"] + PHASES
ONLINE = ["slot_wait_ms.online", "stream_wait_ms.online",
          "device_run_ms.online"]
NOTE = re.compile(r"devtrace: (\d+) dispatches, (\d+) requests enqueued in "
                  r"the window; segments (\S+) ms a request, their union "
                  r"(\S+) ms a request; (\d+) of (\d+) dispatches")


def test_the_new_metrics_are_listed_for_their_cells():
    bench = spec.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for m in DEV + ["enqueue_host_ms"]:
        assert names[m]["workloads"] == ["reddit.batch"]
        assert names[m + ".flickr"]["workloads"] == ["flickr.batch"]
    for m in PHASES:
        assert names[m]["workloads"] == ["reddit.batch", "flickr.batch"]
    for m in ONLINE:
        assert names[m]["workloads"] == ["reddit.online"]


@pytest.mark.parametrize("workload", ["reddit.batch", "flickr.batch"])
def test_a_traced_batch_run_reports_the_span_metrics(workload, tmp_path,
                                                     capfd):
    # a window long enough for several dispatches on a loaded CPU
    out = run_cell(_tiny(workload), 2 ** 31 + 7, 3.0, True, device="cpu",
                   cache_dir=tmp_path)
    assert out["correct"] is True
    # Flickr reports the engines' quantities under names of its own
    own = ".flickr" if workload == "flickr.batch" else ""
    got = {m[:-len(own)] if own and m.endswith(own) else m: v
           for m, v in out["metrics"].items()}
    assert not own or not set(DEV) & set(out["metrics"])
    assert set(DEV + HOST) <= set(got)
    assert all(got[m]["value"] >= 0 for m in DEV + HOST)
    assert got["xw_dev_ms"]["value"] > 0 and got["ell_dev_ms"]["value"] > 0
    assert sum(got[m]["value"] for m in PHASES) \
        <= got["register_s"]["value"]
    # the six segments tile each dispatch: their sum is the union of the
    # dispatches' intervals where no staged pair meets another chain
    n, live, total, union, mixed, _ = NOTE.search(capfd.readouterr().err
                                                  ).groups()
    assert int(n) >= 1 and int(live) >= int(n) and int(mixed) == 0
    assert math.isclose(sum(got[m]["value"] for m in DEV), float(total),
                        rel_tol=1e-9)
    assert math.isclose(float(total), float(union), rel_tol=1e-6)


def _bare_context(tracer, device=None):
    from hgcn_bench.cell import Window
    win = Window("closed")
    win.t_start, win.t_end = 0.0, 1e12
    sess = None if device is None else types.SimpleNamespace(
        device=types.SimpleNamespace(type=device))
    return types.SimpleNamespace(tracer=tracer, win=win, sess=sess,
                                 notes=[])


def _dispatch(tr, chain, live, enqueued, first, seg_s, slot_s):
    """What the program records for one traced dispatch: its slot wait,
    then (on its completion) the chain's segments, back to back."""
    tr.span_at("slot_wait", "serving", enqueued - slot_s, enqueued,
               args={"reqs": list(range(live))})
    t = first
    for name in ("stage",) + devtrace.SEGMENTS[1:] * 2:
        tr.span_at(name, devtrace.SEGMENT_CAT, t, t + seg_s,
                   args={"chain": chain, "live": live, "padded": 4,
                         "enqueued": enqueued})
        t += seg_s


def test_the_online_readers_on_the_programs_spans():
    """The online readers' arithmetic on hand-made spans of two
    dispatches (on the card only: off it they give nothing)."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer(capacity=256, clock=lambda: 0.0)
    _dispatch(tr, 1, 3, enqueued=10.0, first=10.002, seg_s=0.001,
              slot_s=0.0)
    _dispatch(tr, 2, 1, enqueued=11.0, first=11.010, seg_s=0.002,
              slot_s=0.004)
    ctx = _bare_context(tr, "cuda")
    read = {m: spec.load_reader(m) for m in ONLINE}
    # per request: three at 2 ms and one at 10 ms behind the stream
    assert read["stream_wait_ms.online"](ctx) == pytest.approx(2.0)
    # eleven segments a dispatch: 11 ms (three requests) and 22 ms (one)
    assert read["device_run_ms.online"](ctx) == pytest.approx(11.0)
    assert read["slot_wait_ms.online"](ctx) == pytest.approx(0.0)
    # two X·W segments a dispatch, over the four requests
    assert devtrace.dev_ms(ctx, "xw") == pytest.approx(
        1e3 * (2 * 0.001 + 2 * 0.002) / 4)
    for m in ONLINE:
        assert read[m](_bare_context(tr, "cpu")) is None


@pytest.mark.parametrize("metric", DEV + HOST + ONLINE)
def test_a_program_without_the_spans_gives_nothing(metric):
    from repro_torch.obs.trace import Tracer
    read = spec.load_reader(metric)
    tr = Tracer(capacity=8)
    sid = tr.begin("pad", "engine")       # what an older engine records
    tr.end(sid)
    assert read(_bare_context(tr)) is None
    assert read(_bare_context(None)) is None


def test_a_wrapped_ring_gives_nothing_and_says_so():
    from repro_torch.obs.trace import Tracer
    tr = Tracer(capacity=4)
    for _ in range(3):
        tr.end(tr.begin("enqueue", "engine"))
    ctx = _bare_context(tr)
    assert devtrace.host_spans(ctx, "enqueue") is None
    assert any("wrapped" in n for n in ctx.notes)
