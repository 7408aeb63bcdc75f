"""Device spans of the served forward (``repro_torch.obs.device``) on the CPU.

On the CPU a traced dispatch's chain reads the tracer's clock at the
same engine boundaries where the card records CUDA events, so its
structure is checked here: every segment of every layer, contiguous,
tiling the dispatch; nothing recorded with tracing off or while a graph
is captured; the same logits traced or not. Also ``register``'s phases,
the pump's ``linger``/``idle`` waits, ``slot_wait`` and ``enqueue`` on
the simulation's stub queue, and the exporter's segment track.
"""
import time

import numpy as np
import pytest
import torch

from conftest import make_heterogeneous_matrix
from repro_torch.core import csr_from_dense
from repro_torch.engine import Engine
from repro_torch.obs import device as obs_device
from repro_torch.obs.export import SEGMENT_TID, chrome_trace
from repro_torch.obs.report import check_complete
from repro_torch.obs.trace import Tracer
from repro_torch.serving import (RequestQueue, SimClock, StubEngine,
                                 bursty_trace, replay_trace)

F_IN, HIDDEN, CLASSES = 16, 8, 4
LAYER = ("xw", "dense", "ell", "coo", "out")


def _engine(tracer=None, n=300, seed=0):
    rng = np.random.default_rng(seed)
    a = make_heterogeneous_matrix(n, seed=seed)
    ws = [(rng.standard_normal((F_IN, HIDDEN)) * 0.1).astype(np.float32),
          (rng.standard_normal((HIDDEN, CLASSES)) * 0.1).astype(np.float32)]
    eng = Engine(device="cpu")
    if tracer is not None:
        eng.attach_tracer(tracer)
    eng.register("g", csr_from_dense(a), reorder="rcm", weights=ws)
    xs = [torch.from_numpy(rng.standard_normal((n, F_IN)).astype(np.float32))
          for _ in range(4)]
    return eng, xs


def _segments(tracer):
    """The device segments in the ring: (name, args, t0, t1, parent)."""
    begins, out = {}, []
    for e in tracer.events():
        if e["ph"] == "B" and e["cat"] == obs_device.SEGMENT_CAT:
            begins[e["sid"]] = e
        elif e["ph"] == "E" and e["sid"] in begins:
            b = begins.pop(e["sid"])
            out.append((b["name"], b["args"], b["ts"], e["ts"], b["parent"]))
    return out


@pytest.mark.parametrize("members", [1, 3])
def test_a_traced_dispatch_tiles_its_interval_layer_by_layer(members):
    tr = Tracer(capacity=1 << 12)
    eng, xs = _engine(tr)
    outs, meta = eng.serve_group_async([("g", x) for x in xs[:members]])
    chain = meta["chain"]
    meta["complete"]()
    chain.emit(tr, parent=-1, live=members, padded=4 if members > 1 else 1)
    segs = _segments(tr)
    assert [s[0] for s in segs] == ["stage"] + list(LAYER) * 2
    assert [s[1].get("layer") for s in segs] == [None] + [0] * 5 + [1] * 5
    for (_, _, _, end, _), (_, _, begin, _, _) in zip(segs, segs[1:]):
        assert begin == end                       # shared boundaries
    assert all(t1 >= t0 for _, _, t0, t1, _ in segs)
    total = sum(t1 - t0 for _, _, t0, t1, _ in segs)
    assert total == pytest.approx(segs[-1][3] - segs[0][2], abs=1e-12)
    assert segs[0][2] >= chain.t_enqueue
    assert {s[1]["chain"] for s in segs} == {chain.id}
    assert {s[1]["live"] for s in segs} == {members}
    assert len(outs) == members
    assert not chain.marks                        # the events are dropped


def test_tracing_off_records_nothing_and_keeps_the_bits():
    plain, xs = _engine()
    tr = Tracer(capacity=1 << 12)
    traced, _ = _engine(tr)
    reqs = [("g", x) for x in xs[:3]]
    want, meta = plain.serve_group_async(reqs)
    assert "chain" not in meta
    assert not plain.tracer.enabled and plain.tracer.events() == []
    got, meta_t = traced.serve_group_async(reqs)
    assert meta_t["chain"] is not None
    for y, z in zip(want, got):
        assert torch.equal(y, z)
    xp = plain.prepare_x("g", xs[0])
    assert torch.equal(xp, traced.prepare_x("g", xs[0]))
    assert not getattr(plain._staged, "pairs", None)


def test_no_device_span_while_the_stream_captures(monkeypatch):
    tr = Tracer(capacity=1 << 12)
    eng, xs = _engine(tr)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert obs_device.capturing()
    xp = eng.prepare_x("g", xs[0])
    _, meta = eng.serve_group_async([("g", xs[0]), ("g", xs[1])],
                                    [xp, eng.prepare_x("g", xs[1])])
    assert "chain" not in meta
    assert not getattr(eng._staged, "pairs", None)
    assert _segments(tr) == []
    assert [e["name"] for e in tr.events() if e["ph"] == "B"
            and e["name"] != "register"
            and e["parent"] < 0] == ["enqueue"]


def test_executors_built_before_the_tracer_emit_after_it():
    eng, xs = _engine()
    for b in (1, 2, 4):                       # builds every executor
        eng.serve_group([("g", xs[0])] * b)
    built = eng.executors.size
    tr = Tracer(capacity=1 << 12)
    q = RequestQueue(eng, pipelined=True, max_inflight=2, target_batch=4,
                     tracer=tr).start()
    futs = [q.submit("g", x) for x in xs]
    ys = [f.result(timeout=60) for f in futs]
    q.stop()
    assert eng.executors.size == built        # nothing was rebuilt
    segs = _segments(tr)
    devs = {e["sid"] for e in tr.events()
            if e["ph"] == "B" and e["name"] == "device"}
    assert segs and {s[4] for s in segs} <= devs
    by_chain = {}
    for name, args, *_ in segs:
        by_chain.setdefault(args["chain"], []).append(
            (name, args.get("prepared", False)))
    for names in by_chain.values():
        chain = [n for n, pre in names if not pre]
        assert chain == ["stage"] + list(LAYER) * 2
        # the staging worker's prepare_x pairs joined their dispatch
        assert sum(pre for _, pre in names) >= 1
    assert sum(s[1]["live"] for s in segs if s[0] == "xw"
               and s[1]["layer"] == 0) == len(xs)
    assert len(ys) == len(xs)
    assert check_complete(chrome_trace(tr.events())) == []


def test_register_phases_are_timed_and_traced():
    eng, _ = _engine()
    h = eng.handle("g")
    assert set(h.phases) == {"reorder", "partition", "place"}
    assert all(v >= 0 for v in h.phases.values())
    assert h.phases["partition"] > 0 and h.phases["place"] > 0
    assert sum(h.phases.values()) <= h.preprocess_s
    tr = Tracer(capacity=1 << 10)
    _engine(tr)
    evs = tr.events()
    reg = [e for e in evs if e["ph"] == "B" and e["name"] == "register"]
    assert len(reg) == 1
    kids = [e["name"] for e in evs if e["ph"] == "B"
            and e["parent"] == reg[0]["sid"]]
    assert kids == ["reorder", "partition", "place"]
    assert check_complete(chrome_trace(evs)) == []


def _stub_queue(clock, tracer, **kw):
    engine = StubEngine(clock, stage_s=0.004, compile_s=0.25)
    names = ["p0", "p1"]
    for n in names:
        engine.register(n)
    xs = {n: np.full((4, 3), float(i + 1), np.float32)
          for i, n in enumerate(names)}
    q = RequestQueue(engine, target_batch=4, default_deadline_ms=800.0,
                     clock=clock, tracer=tracer, **kw)
    return q, names, xs


def test_slot_wait_and_enqueue_on_the_stub_queue():
    clock = SimClock()
    tr = Tracer(capacity=1 << 14, clock=clock)
    q, names, xs = _stub_queue(clock, tr, pipelined=True, max_inflight=1)
    trace = bursty_trace(4, 8, 0.02, names, seed=1)
    futs, _ = replay_trace(q, trace, xs.__getitem__)
    q.drain()
    assert all(f.done() for f in futs)
    doc = chrome_trace(tr.events())
    assert check_complete(doc) == []
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names_seen = {e["name"] for e in spans}
    assert {"slot_wait", "enqueue", "staging", "device"} <= names_seen
    staging = {e["args"]["sid"] for e in spans if e["name"] == "staging"}
    waits = [e for e in spans if e["name"] == "slot_wait"]
    assert waits and all(e["args"]["parent"] in staging for e in waits)
    assert sum(len(e["args"]["reqs"]) for e in waits) == len(trace)
    # a full window of one makes later batches wait in virtual time
    assert max(e["dur"] for e in waits) > 0


def test_the_pumps_linger_and_idle_on_the_stub_queue():
    clock = SimClock()
    tr = Tracer(capacity=1 << 12, clock=clock)
    q, names, xs = _stub_queue(clock, tr)
    q.start()
    try:
        futs = [q.submit(names[0], xs[names[0]])]     # 1 of 4: lingers
        deadline = time.monotonic() + 30
        while not any(e["name"] == "linger" for e in tr.events()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        futs += [q.submit(names[0], xs[names[0]]) for _ in range(3)]
        for f in futs:
            f.result(timeout=30)
        while not any(e["name"] == "idle" for e in tr.events()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        q.stop()
    doc = chrome_trace(tr.events())
    assert check_complete(doc) == []
    spans = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert spans["linger"]["args"]["depth"] >= 1
    assert spans["idle"]["args"]["depth"] == 0
    assert "enqueue" in spans


def test_segments_export_to_a_device_track_of_their_own():
    tr = Tracer(capacity=1 << 12)
    eng, xs = _engine(tr)
    _, meta = eng.serve_group_async([("g", xs[0])])
    meta["chain"].emit(tr, live=1, padded=1)
    doc = chrome_trace(tr.events())
    segs = [e for e in doc["traceEvents"]
            if e.get("cat") == obs_device.SEGMENT_CAT]
    assert len(segs) == 11
    assert {(e["pid"], e["tid"]) for e in segs} == {(2, SEGMENT_TID)}
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("tid") == SEGMENT_TID]
    assert names == ["device (measured)"]


@pytest.mark.cuda
def test_cuda_segments_tile_each_dispatch_on_the_card():
    """On the card: the same logits traced or not, every chain's CUDA
    events on the tracer's clock, contiguous, inside the host window of
    the run, and the clock anchor's drift small."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    a = make_heterogeneous_matrix(900, seed=1)
    ws = [(rng.standard_normal((F_IN, HIDDEN)) * 0.1).astype(np.float32),
          (rng.standard_normal((HIDDEN, CLASSES)) * 0.1).astype(np.float32)]
    xs = [torch.from_numpy(rng.standard_normal((900, F_IN)).astype(
        np.float32)).cuda() for _ in range(12)]

    def serve(tracer):
        eng = Engine(device="cuda")
        eng.register("g", csr_from_dense(a), reorder="rcm", weights=ws)
        q = RequestQueue(eng, pipelined=True, max_inflight=2,
                         target_batch=4, tracer=tracer).start()
        ys = [f.result(timeout=120)
              for f in [q.submit("g", x) for x in xs]]
        q.stop()
        return ys

    want = serve(None)
    tr = Tracer(capacity=1 << 14)
    t0 = tr.clock()
    got = serve(tr)
    t1 = tr.clock()
    for y, z in zip(want, got):
        assert torch.equal(y, z)
    segs = _segments(tr)
    by_chain = {}
    for s in segs:
        by_chain.setdefault(s[1]["chain"], []).append(s)
    assert by_chain and sum(
        ss[1][1]["live"] for ss in by_chain.values()) == len(xs)
    for ss in by_chain.values():
        chain = [s for s in ss if not s[1].get("prepared")]
        assert [s[0] for s in chain] == ["stage"] + list(LAYER) * 2
        for x, y in zip(chain, chain[1:]):
            assert y[2] == x[3]
        assert t0 <= chain[0][2] and chain[-1][3] <= t1
        assert chain[0][1]["enqueued"] <= chain[0][2] + 1e-4
    drift, span = tr.device_clock.drift_s()
    assert span > 0 and abs(drift) < 2e-4


def test_the_waits_open_profiler_ranges_on_their_thread():
    """The inline pipeline stages and waits on the caller's thread, so a
    profiler started there records the ``repro.*`` ranges beside the
    spans."""
    from torch.profiler import ProfilerActivity, profile
    clock = SimClock()
    tr = Tracer(capacity=1 << 14, clock=clock)
    q, names, xs = _stub_queue(clock, tr, pipelined=True, max_inflight=1)
    trace = bursty_trace(2, 8, 0.02, names, seed=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        replay_trace(q, trace, xs.__getitem__)
        q.drain()
    seen = {e.name for e in prof.events() if e.name.startswith("repro.")}
    assert {"repro.staging", "repro.slot_wait",
            "repro.wait_device"} <= seen


def test_a_range_open_when_a_profiler_starts_closes_quietly():
    """A serving thread's range entered before a profiler starts (the
    pump idling) must close without raising once the profiler runs: the
    raw fast range asserts there, which would end the pump's thread."""
    from torch.profiler import ProfilerActivity, profile
    rng = obs_device.enter_range("idle")
    with profile(activities=[ProfilerActivity.CPU]):
        obs_device.exit_range(rng)
        inner = obs_device.enter_range("slot_wait")
    obs_device.exit_range(inner)
    obs_device.exit_range(None)
