"""The port's observability modules against the JAX package's.

``repro_torch.obs`` (metrics, tracer, Chrome/Perfetto export, trace
report) is pure Python, copied from ``repro.obs``. The same operation
streams go through both and must give the same values exactly: metric
snapshots, percentiles, tracer events, and the exported trace JSON of a
queue run on a ``SimClock`` (virtual time, so both runs see the same
timestamps).
"""
import json

import numpy as np
import pytest

import repro.obs.export as r_export
import repro.obs.metrics as r_metrics
import repro.obs.report as r_report
import repro.obs.trace as r_trace
import repro.serving as r_serving
import repro_torch.obs.export as p_export
import repro_torch.obs.metrics as p_metrics
import repro_torch.obs.report as p_report
import repro_torch.obs.trace as p_trace
import repro_torch.serving as p_serving

SAMPLES = [[], [3.0], [1.0, 2.0, 3.0, 4.0],
           list(np.random.default_rng(0).exponential(0.01, 257))]


def test_obs_exports_match_reference():
    import repro.obs as r_obs
    import repro_torch.obs as p_obs
    assert p_obs.__all__ == r_obs.__all__


@pytest.mark.parametrize("q", [0, 50, 90, 99, 100])
@pytest.mark.parametrize("i", range(len(SAMPLES)))
def test_percentile_matches_reference(i, q):
    xs = SAMPLES[i]
    assert p_metrics.percentile(xs, q) == r_metrics.percentile(xs, q)
    assert p_metrics.percentile_ms(xs, q) == r_metrics.percentile_ms(xs, q)


def _drive_metrics(m):
    """One stream of metric operations; returns the registry snapshot
    and every metric's own reads."""
    reg = m.MetricsRegistry()
    c = reg.counter("c")
    g = reg.gauge("g")
    h = reg.histogram("h", window=5)
    f = reg.family("f")
    gf = m.GaugeFamily("gf", reg)
    for i, v in enumerate(SAMPLES[3][:40]):
        c.inc(i % 3)
        g.set(v)
        g.set_max(v * 2)
        h.observe(v)
        f.inc(("a", "b")[i % 2], i)
        gf.set(i % 3, v)
        gf.set_max(i % 3, v / 2)
    reads = (c.value, g.value, h.count, h.total, h.values(), h.mean(),
             h.percentile(75), f.get("a"), f.total(), f.as_dict(),
             gf.as_dict(), gf.get(1), reg.names())
    return reg.snapshot(), reads


def test_metrics_match_reference():
    assert _drive_metrics(p_metrics) == _drive_metrics(r_metrics)


def _drive_tracer(tr_mod, clock):
    tr = tr_mod.Tracer(capacity=64, clock=clock)
    root = tr.begin("request", "serving", req=0, args={"n": 1})
    child = tr.begin("queue", "serving", req=0, parent=root)
    clock.advance(0.25)
    tr.instant("cache.hit", "engine", parent=child, args={"kind": "gcn"})
    tr.end(child, args={"reason": "size"})
    dev = tr.begin("device", "device", parent=root, args={"replica": 1})
    clock.advance(0.5)
    tr.end(dev)
    tr.end(root, args={"missed": False})
    tr.begin("request", "serving", req=tr.reject_id(), args={"rejected": 1})
    off = tr_mod.NULL_TRACER
    assert off.begin("x") == -1 and not off.enabled
    return tr


def test_tracer_events_and_export_match_reference(tmp_path):
    r = _drive_tracer(r_trace, r_serving.SimClock())
    p = _drive_tracer(p_trace, p_serving.SimClock())
    assert p.events() == r.events()
    assert p.wrapped() == r.wrapped() is False
    meta = {"run": "unit"}
    doc_r = r_export.write_chrome_trace(str(tmp_path / "r.json"), r,
                                        metadata=meta)
    doc_p = p_export.write_chrome_trace(str(tmp_path / "p.json"), p,
                                        metadata=meta)
    assert doc_p == doc_r
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()
    # the unclosed rejected root is reported the same way by both
    assert p_report.check_complete(doc_p) == r_report.check_complete(doc_r)
    assert p_report.check_complete(doc_p)
    assert p_report.spans(doc_p) == r_report.spans(doc_r)


def test_tracer_ring_wrap_matches_reference():
    docs = []
    for mod, sim in ((r_trace, r_serving.SimClock),
                     (p_trace, p_serving.SimClock)):
        tr = mod.Tracer(capacity=4, clock=sim())
        for i in range(3):
            tr.end(tr.begin("s", args={"i": i}))
        docs.append((tr.wrapped(), tr.events()))
    assert docs[0] == docs[1] and docs[1][0]


def test_label_matches_reference():
    class WithSummary:
        def summary(self):
            return "class T=64"

    class Broken:
        def summary(self):
            raise RuntimeError

        def __str__(self):
            return "broken"

    for obj in (WithSummary(), Broken(), 3, "x"):
        assert p_trace.label(obj) == r_trace.label(obj)


def _traced_queue_doc(serving, trace_mod, export_mod, pipelined):
    """A bursty trace through a traced queue over the stub engine on a
    SimClock; the exported Chrome trace document."""
    clock = serving.SimClock()
    engine = serving.StubEngine(clock, stage_s=0.004, compile_s=0.25)
    names = [f"p{i}" for i in range(3)]
    for n in names:
        engine.register(n)
    xs = {n: np.full((4, 3), float(i + 1), np.float32)
          for i, n in enumerate(names)}
    tracer = trace_mod.Tracer(capacity=1 << 14, clock=clock)
    queue = serving.RequestQueue(engine, target_batch=4,
                                 default_deadline_ms=800.0, clock=clock,
                                 pipelined=pipelined, tracer=tracer)
    trace = serving.bursty_trace(6, 6, 0.03, names, seed=3)
    trace = [serving.Arrival(a.t_s + 0.05, a.name) for a in trace]
    futs, _ = serving.replay_trace(queue, trace, xs.__getitem__)
    queue.drain()
    assert all(f.done() for f in futs)
    return export_mod.chrome_trace(tracer.events(),
                                   metadata=queue.stats.snapshot())


# spans the port's tracer records and the reference's does not: the pump's
# waits, the wait for an in-flight slot, the engine's enqueue (the
# reference's engine has a pad span instead, which its stub never
# records) and the measured device segments
PORT_ONLY = ("linger", "idle", "slot_wait", "enqueue")


def port_only(event) -> bool:
    return event.get("name") in PORT_ONLY \
        or event.get("cat") == p_export.SEGMENT_CAT


def _reference_view(doc):
    """``doc`` without the port-only spans, its span ids renumbered in
    order (the port-only spans take ids from the same sequence) and
    every parent link mapped with them; every other event and field as
    it was."""
    out = json.loads(json.dumps(doc))
    out["traceEvents"] = [e for e in out["traceEvents"] if not port_only(e)]
    sids = sorted(e["args"]["sid"] for e in out["traceEvents"]
                  if e.get("ph") in ("X", "i"))
    rank = {sid: k + 1 for k, sid in enumerate(sids)}
    for e in out["traceEvents"]:
        a = e.get("args")
        if e.get("ph") in ("X", "i"):
            a["sid"] = rank[a["sid"]]
            if a["parent"] in rank:
                a["parent"] = rank[a["parent"]]
    return out


def _device_opened_at_enqueue(doc):
    """The serial ``device`` spans without their timing. The port's
    serial dispatch opens the span when ``serve_group_async`` returns and
    waits on the completion hook inside it; the reference calls the stub's
    blocking ``serve_group`` (which waits before it returns) and opens
    the span after. So on the stub the reference's span is empty in
    virtual time and the port's covers the modeled device time; every
    other event and field is the same."""
    out = json.loads(json.dumps(doc))
    for e in out["traceEvents"]:
        if e.get("name") == "device":
            e.pop("ts"), e.pop("dur")
    return out


@pytest.mark.parametrize("pipelined", [False, True])
def test_traced_queue_exports_match_reference(pipelined):
    doc_r = _traced_queue_doc(r_serving, r_trace, r_export, pipelined)
    doc_p = _traced_queue_doc(p_serving, p_trace, p_export, pipelined)
    assert p_report.check_complete(doc_p) == []
    assert any(e.get("name") == "enqueue" for e in doc_p["traceEvents"])
    if pipelined:
        assert _reference_view(doc_p) == _reference_view(doc_r)
        assert p_report.overlap_check(doc_p) == r_report.overlap_check(doc_r)
    else:
        assert _device_opened_at_enqueue(_reference_view(doc_p)) == \
            _device_opened_at_enqueue(_reference_view(doc_r))
        dev = [e["dur"] for e in doc_p["traceEvents"]
               if e.get("name") == "device"]
        assert dev and min(dev) > 0
    assert p_report.report(doc_p).keys() == r_report.report(doc_r).keys()
