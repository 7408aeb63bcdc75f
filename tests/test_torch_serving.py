"""The port's serving front end against the JAX package's.

``repro_torch.serving`` is the reference's queue, scheduler, pipeline,
replica router, chaos harness and resilience layer over the port's
``Engine``. Three levels of parity:

* every simulation smoke (``run_*_smoke``: ``SimClock`` replays over the
  ``StubEngine``, deterministic by construction) returns the reference's
  dict exactly;
* over the real engines on the CPU — ``repro.engine.Engine`` and
  ``repro_torch.engine.Engine(device="cpu")`` holding the same graphs
  and weights — the same submissions close the same batches for the
  same reasons, with the same ``stats()["serving"]`` counts, and logits
  within ``rtol=1e-4, atol=1e-5`` (X·W and the row sums add in another
  order than XLA's). Both queues get an explicit ``LatencyModel`` with
  no prior, so the engines' latency priors (the H100's in the port, the
  TPU's in the reference) cannot change when a batch closes. Within the
  port, pipelined and two-replica dispatch give the serial bits;
* the port's own pieces: ``outputs_finite`` on tensors and arrays, and
  ``latency_prior``, which is the reference's formula at the H100's
  peaks.

Tests marked ``cuda`` need a card and skip without one; the JAX
package's engine is imported only inside the CPU tests, so they run on
a card machine without JAX.
"""
import numpy as np
import pytest
import torch

import repro.serving as r_serving
import repro_torch.core as tc
import repro_torch.serving as p_serving
from repro_torch.analysis import roofline as p_roofline
from repro_torch.convert import weights_from_numpy
from repro_torch.engine import Engine
from repro_torch.serving.resilience import outputs_finite

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
SMOKES = ("run_smoke", "run_pipeline_smoke", "run_trace_smoke",
          "run_lifecycle_smoke", "run_replica_smoke",
          "run_replica_fault_smoke", "run_chaos_smoke")


def test_serving_exports_match_reference():
    assert p_serving.__all__ == r_serving.__all__


@pytest.mark.parametrize("smoke", SMOKES)
def test_simulation_smoke_matches_reference(smoke):
    # Every field is virtual time, a count or a ratio on a SimClock: no
    # wall clock or temp path reaches the returned dicts, so they must be
    # equal as they are.
    want = getattr(r_serving, smoke)(verbose=False)
    got = getattr(p_serving, smoke)(verbose=False)
    assert got == want


# ------------------------------------------------------ real engines ----
F_IN, HIDDEN, CLASSES = 16, 8, 4


def _family():
    """Three graphs of one shape class, their weights and two feature
    matrices per graph (numpy, seeded)."""
    rng = np.random.default_rng(0)
    mats, ws, xs = {}, {}, {}
    for i in range(3):
        n = 300 + 4 * i
        mats[f"g{i}"] = make_heterogeneous_matrix(n, seed=i)
        ws[f"g{i}"] = [
            (rng.standard_normal((F_IN, HIDDEN)) * 0.1).astype(np.float32),
            (rng.standard_normal((HIDDEN, CLASSES)) * 0.1).astype(np.float32)]
        xs[f"g{i}"] = [rng.standard_normal((n, F_IN)).astype(np.float32)
                       for _ in range(2)]
    return mats, ws, xs


@pytest.fixture(scope="module")
def family():
    return _family()


def _ref_engine(family):
    import repro.core as rc
    import repro.engine as r_engine
    mats, ws, _ = family
    eng = r_engine.Engine(backend="xla")
    for name, a in mats.items():
        eng.register(name, rc.csr_from_dense(a), weights=ws[name])
    return eng


def _port_engine(family, device="cpu"):
    mats, ws, _ = family
    eng = Engine(device=device)
    for name, a in mats.items():
        eng.register(name, tc.csr_from_dense(a),
                     weights=weights_from_numpy(ws[name], device=device))
    return eng


def _scenario(serving, engine, xs, **queue_kw):
    """Size, deadline and drain closes on a SimClock; returns (queue,
    futures in submit order)."""
    clock = serving.SimClock()
    queue = serving.RequestQueue(
        engine, target_batch=4, clock=clock, default_deadline_ms=500.0,
        latency_model=serving.LatencyModel(prior=None), **queue_kw)
    futs = []

    def submit(name, v, **kw):
        futs.append(queue.submit(name, xs[name][v], **kw))
        queue.pump()

    # a size close: four same-key requests
    for name, v in (("g0", 0), ("g1", 0), ("g2", 0), ("g0", 1)):
        submit(name, v)
    # a deadline close: a lone request lingers until its slack runs out
    submit("g1", 1, deadline_ms=300.0)
    clock.advance(0.25)
    queue.pump()
    # a drain close of three
    for name, v in (("g2", 1), ("g0", 0), ("g1", 0)):
        submit(name, v)
    queue.drain()
    return queue, futs


def test_queue_over_real_engine_matches_reference(family):
    _, _, xs = family
    ref, port = _ref_engine(family), _port_engine(family)
    q_ref, f_ref = _scenario(r_serving, ref, xs)
    q_port, f_port = _scenario(p_serving, port, xs)
    assert q_port.stats.close_reasons == q_ref.stats.close_reasons == {
        "size": 1, "deadline": 1, "drain": 1}
    assert q_port.stats.batch_hist == q_ref.stats.batch_hist
    assert port.stats()["serving"] == ref.stats()["serving"]
    assert port.stats()["serving"]["completed"] == 8
    for a, b in zip(f_port, f_ref):
        y = a.result(timeout=0)
        assert isinstance(y, torch.Tensor)
        np.testing.assert_allclose(y.numpy(), np.asarray(b.result(timeout=0)),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("mode", [dict(pipelined=True), dict(replicas=2)])
def test_pipelined_and_replicas_give_serial_bits(family, mode):
    _, _, xs = family
    port = _port_engine(family)
    _, serial = _scenario(p_serving, port, xs)
    q, other = _scenario(p_serving, port, xs, **mode)
    assert q.inflight() == 0
    for a, b in zip(other, serial):
        assert torch.equal(a.result(timeout=0), b.result(timeout=0))


def test_queue_over_real_engine_equals_serve_group(family):
    _, _, xs = family
    port = _port_engine(family)
    queue = p_serving.RequestQueue(port, target_batch=4,
                                   clock=p_serving.SimClock(),
                                   default_deadline_ms=60_000.0)
    reqs = [("g0", xs["g0"][0]), ("g1", xs["g1"][0]), ("g2", xs["g2"][1]),
            ("g1", xs["g1"][1])]
    futs = [queue.submit(n, x) for n, x in reqs]
    queue.pump()
    want = port.serve_group(reqs)
    for f, w in zip(futs, want):
        assert torch.equal(f.result(timeout=0), w)


def test_poisoned_request_is_quarantined_over_real_engine(family):
    _, _, xs = family
    port = _port_engine(family)
    reqs = [("g0", xs["g0"][0]), ("g1", xs["g1"][0]), ("g2", xs["g2"][0]),
            ("g0", xs["g0"][1])]
    clean = port.serve_group(reqs)
    inj = p_serving.ChaosInjector(p_serving.FaultPlan(
        [p_serving.FaultSpec(site="poison", at=0, member=2)]))
    queue = p_serving.RequestQueue(port, target_batch=4,
                                   clock=p_serving.SimClock(),
                                   default_deadline_ms=60_000.0,
                                   injector=inj, resilience=True)
    futs = [queue.submit(n, x) for n, x in reqs]
    queue.drain()
    with pytest.raises(p_serving.PoisonedRequest):
        futs[2].result(timeout=0)
    for i in (0, 1, 3):
        torch.testing.assert_close(futs[i].result(timeout=0), clean[i],
                                   **LOGIT_TOL)
    assert queue.stats.snapshot()["resilience"]["quarantined"] == 1


def test_executor_cache_counts_hold_under_concurrent_lookups(family):
    """Staging workers, replica lanes and the pump thread look executors
    up at once: every lookup is a hit or a miss, and each key builds
    once (a lost update or a double build breaks one of the two)."""
    import sys
    import threading
    port = _port_engine(family)
    sc, f_in, w_shapes = port.group_key("g0", family[2]["g0"][0])
    ex = port.replica_view(0).executors
    n_threads, calls = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(calls):
                ex.gcn_batched(sc, f_in + (i + t) % 5, w_shapes, 4)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    st = ex.stats_snapshot()
    assert st["misses"] == 5 == ex.size
    assert st["hits"] + st["misses"] == n_threads * calls


# ------------------------------------------------------- port pieces ----
NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("outs, want", [
    ([torch.ones(3), torch.zeros(2, 2)], True),
    ([torch.ones(3), torch.tensor([1.0, NAN])], False),
    ([torch.tensor([[-INF, 0.0]])], False),
    ([torch.tensor([1, 2], dtype=torch.int32)], True),
    ([torch.tensor([1 + 1j, complex(NAN, 0)])], False),
    ([torch.empty(0)], True),
    ([np.ones(3), np.zeros(2)], True),
    ([np.array([1.0, np.nan])], False),
    ([np.array([np.inf], np.float32)], False),
    ([np.array([1, 2], np.int32)], True),
    ([np.ones(2), torch.tensor([NAN])], False),
    ([], True),
])
def test_outputs_finite(outs, want):
    assert outputs_finite(outs) is want
    arrays = [np.asarray(y) for y in outs]
    assert r_serving.resilience.outputs_finite(arrays) is want


def test_latency_prior_is_the_reference_formula_at_h100_peaks(
        family, monkeypatch):
    import repro.analysis.roofline as r_roofline
    import repro.engine as r_engine
    assert (p_roofline.PEAK_FLOPS, p_roofline.HBM_BW) == (67e12, 3.35e12)
    monkeypatch.setattr(r_roofline, "PEAK_FLOPS", p_roofline.PEAK_FLOPS)
    monkeypatch.setattr(r_roofline, "HBM_BW", p_roofline.HBM_BW)
    monkeypatch.setattr(r_engine.Engine, "LAUNCH_FLOOR_S",
                        Engine.LAUNCH_FLOOR_S)
    _, _, xs = family
    ref, port = _ref_engine(family), _port_engine(family)
    view = port.replica_view(1)
    above_floor = 0
    for name in ("g0", "g2"):
        x = xs[name][0]
        for x_w in (x, x[:, :3]):
            rk, pk = ref.group_key(name, x_w), port.group_key(name, x_w)
            for batch in (0, 1, 2, 4, 64, 1 << 20):
                want = ref.latency_prior(rk, batch)
                assert port.latency_prior(pk, batch) == want
                assert view.latency_prior(pk, batch) == want
                above_floor += want > Engine.LAUNCH_FLOOR_S
    assert above_floor > 0
    assert port.latency_prior(("stub-class", 3), 4) is None


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_outputs_finite(cuda_device):
    assert outputs_finite([torch.ones(4, device=cuda_device)])
    assert not outputs_finite([torch.ones(4, device=cuda_device),
                               torch.tensor([NAN], device=cuda_device)])


@pytest.mark.cuda
def test_cuda_serial_latency_sample_covers_the_device_time(cuda_device,
                                                            family):
    """The serial dispatch must wait for the card before it reads the
    clock: each warm latency sample is at least the device time of its
    dispatch, measured with CUDA events. A ~10 ms device sleep enqueued
    ahead of each dispatch makes an enqueue-only sample fall short."""
    _, _, xs = family
    port = _port_engine(family, device=cuda_device)
    reqs = [("g0", xs["g0"][0]), ("g1", xs["g1"][0]), ("g2", xs["g2"][0]),
            ("g0", xs["g0"][1])]
    port.serve_group(reqs)       # warm: builds the kernels and executors
    torch.cuda.synchronize()
    events, samples = [], []
    orig = port.serve_group_async

    def timed(requests, prepared=None, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        out = orig(requests, prepared, **kw)
        end.record()
        events.append((start, end))
        return out

    port.serve_group_async = timed
    queue = p_serving.RequestQueue(port, target_batch=4,
                                   default_deadline_ms=60_000.0)
    observe = queue.latency.observe

    def record(key, batch, dt_s=None, **kw):
        samples.append((dt_s, kw.get("cold", False)))
        observe(key, batch, dt_s, **kw)

    queue.latency.observe = record
    queue.start()
    try:
        futs = [queue.submit(n, x) for _ in range(3) for n, x in reqs]
        for f in futs:
            f.result(timeout=60)
    finally:
        queue.stop()
    torch.cuda.synchronize()
    assert len(samples) == len(events) == 3
    for (dt_s, cold), (start, end) in zip(samples, events):
        assert not cold
        assert dt_s * 1e3 >= start.elapsed_time(end) >= 5.0
