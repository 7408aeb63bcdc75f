"""The port's Engine lifecycle, replica views and ELL dispatches against
the JAX reference.

``class_waste_by_class``, ``plan_retirement``, ``execute_retirement`` and
a ``LifecycleManager`` window sequence hold EXACT parity with
``repro.engine`` on the reference's own lifecycle world (three
heterogeneous graphs of 300/304/308 nodes in one shape class): the same
class summaries, waste numbers, plans, padded arrays and snapshots.
Retirement must be bitwise-invisible in the port's outputs, as the
reference holds it (``tests/test_lifecycle.py``). Logits against the
reference: ``rtol=1e-4, atol=1e-5`` (X·W and the row sums added in
another order than XLA's); within the port: bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
import repro_torch.core as tc
from repro.engine.lifecycle import LifecycleConfig as RefLifecycleConfig
from repro.engine.lifecycle import LifecycleManager as RefLifecycleManager
from repro_torch.core.formats import to_numpy
from repro_torch.engine import Engine, LifecycleConfig, LifecycleManager

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _world(make_engine, csr_from_dense, **kw):
    """The reference's TestRealEngineRetirement world."""
    eng = make_engine(**kw)
    rng = np.random.default_rng(0)
    xs = {}
    ws = [(rng.standard_normal((16, 8)) * 0.1).astype(np.float32),
          (rng.standard_normal((8, 4)) * 0.1).astype(np.float32)]
    for i, n in enumerate([300, 304, 308]):
        a = make_heterogeneous_matrix(n, seed=i)
        eng.register(f"g{i}", csr_from_dense(a), weights=ws)
        xs[f"g{i}"] = rng.standard_normal((n, 16)).astype(np.float32)
    return eng, xs


def _port(**kw):
    return _world(lambda **k: Engine(device="cpu", **k), tc.csr_from_dense,
                  **kw)


def _ref(**kw):
    return _world(re_.Engine, rc.csr_from_dense, **kw)


def _by_summary(d: dict) -> dict:
    return {sc.summary(): v for sc, v in d.items()}


def _assert_same_partition(port_part, ref_part):
    for pc, rcomp in zip(port_part, ref_part):
        for a, b in zip(pc, rcomp):
            a, b = to_numpy(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- lifecycle -----
def test_class_waste_matches_reference_exactly():
    port, _ = _port()
    ref, _ = _ref()
    assert port.class_waste() == ref.class_waste()
    assert _by_summary(port.class_waste_by_class()) == \
        _by_summary(ref.class_waste_by_class())
    sc = port.handle("g0").sclass
    assert port.members_of(sc) == ref.members_of(ref.handle("g0").sclass) \
        == ["g0", "g1", "g2"]
    assert "class_waste" in port.stats()


def test_plan_and_execute_retirement_match_reference_exactly():
    port, _ = _port()
    ref, _ = _ref()
    psc, rsc = port.handle("g0").sclass, ref.handle("g0").sclass
    assert psc.summary() == rsc.summary()
    pplan, rplan = port.plan_retirement(psc), ref.plan_retirement(rsc)
    assert pplan.names == rplan.names
    assert [t.summary() for t in pplan.targets] == \
        [t.summary() for t in rplan.targets]
    assert [t.summary() for t in pplan.new_classes] == \
        [t.summary() for t in rplan.new_classes]
    port.infer("g0", np.ones((300, 16), np.float32))
    ref.infer("g0", np.ones((300, 16), np.float32))
    assert port.execute_retirement(pplan) == ref.execute_retirement(rplan)
    assert port.registry.stats() == ref.registry.stats()
    assert port.class_waste() == ref.class_waste()
    for name in pplan.names:
        ph, rh = port.handle(name), ref.handle(name)
        assert ph.sclass.summary() == rh.sclass.summary()
        assert dataclasses.asdict(ph.padded_meta) == \
            dataclasses.asdict(rh.padded_meta)
        _assert_same_partition(ph.part, rh.part)
        assert ph.part.ell.cols.device == port.device
    assert port.plan_retirement(psc) is None    # no members left


@pytest.mark.parametrize("dispatch", ["ragged", "fused", "loop"])
def test_retirement_is_bitwise_invisible(dispatch):
    eng, xs = _port(ell_dispatch=dispatch)
    b = np.random.default_rng(1).standard_normal((300, 5)).astype(np.float32)
    pre = {k: eng.infer(k, x) for k, x in xs.items()}
    pre_spmm = eng.spmm("g0", b)
    pair = [("g0", xs["g0"]), ("g2", xs["g2"])]   # one class after, too
    pre_group = eng.serve_group(pair)
    sc = eng.handle("g0").sclass
    res = eng.execute_retirement(eng.plan_retirement(sc))
    assert res["members"] == 3 and res["executors_invalidated"] >= 1
    assert eng.stats()["stacks"] == 0          # stale member stacks dropped
    succ = eng.handle("g0").sclass
    assert succ != sc and succ.ell_mac_capacity < sc.ell_mac_capacity
    for k, x in xs.items():
        assert torch.equal(eng.infer(k, x), pre[k])
    assert torch.equal(eng.spmm("g0", b), pre_spmm)
    assert eng.group_key("g0", xs["g0"]) == eng.group_key("g2", xs["g2"])
    for y, y0 in zip(eng.serve_group(pair), pre_group):
        assert torch.equal(y, y0)


def test_lifecycle_manager_snapshots_match_reference():
    cfg = dict(waste_budget=0.05, breach_windows=2, min_traffic=1,
               cooldown_windows=1)
    port, xs = _port()
    ref, _ = _ref()
    pm = LifecycleManager(port, config=LifecycleConfig(**cfg))
    rm = RefLifecycleManager(ref, config=RefLifecycleConfig(**cfg))
    pre = {k: port.infer(k, x) for k, x in xs.items()}
    retired = 0
    for window in range(4):
        for eng in (port, ref):
            for k, x in xs.items():
                eng.infer(k, x)
        pw, rw = pm.step(), rm.step()
        assert pw == rw, f"window {window}"
        assert pm.snapshot() == rm.snapshot(), f"window {window}"
        assert port.stats()["lifecycle"] == pm.snapshot()
        retired += len(pw["retired"])
    assert retired >= 1, "the budget must retire the class at least once"
    for k, x in xs.items():
        y = port.infer(k, x)
        assert torch.equal(y, pre[k])
        np.testing.assert_allclose(y.numpy(), np.asarray(ref.infer(k, x)),
                                   **LOGIT_TOL)


# -------------------------------------------------------- replica views ----
def test_replica_view_has_a_private_cache_and_equal_outputs():
    eng, xs = _port()
    view = eng.replica_view(0)
    assert eng.replica_view(0) is view
    assert view.executors is not eng.executors
    assert eng.replica_view(1).executors is not view.executors
    assert view.executors.device == eng.device
    group = [("g0", xs["g0"]), ("g2", xs["g2"])]   # one class after, too
    own = eng.serve_group(group)
    misses = eng.executors.stats_snapshot()
    outs, meta = view.serve_group_async(group)
    assert meta["cold"] is True       # the view's own cache built it
    assert eng.executors.stats_snapshot() == misses   # engine cache unused
    for y, y0 in zip(outs, own):
        assert torch.equal(y, y0)
    for y, y0 in zip(view.serve_group(group), own):
        assert torch.equal(y, y0)
    assert view.group_key("g0", xs["g0"]) == eng.group_key("g0", xs["g0"])
    assert view.handle("g1") is eng.handle("g1")
    sc = eng.handle("g0").sclass
    assert eng.class_traffic()[sc] == (
        eng.executors.traffic_by_class()[sc]
        + view.executors.traffic_by_class()[sc])
    res = eng.execute_retirement(eng.plan_retirement(sc))
    assert view.executors.size == 0      # every replica cache invalidated
    assert res["executors_invalidated"] == 2
    for y, y0 in zip(view.serve_group(group), own):
        assert torch.equal(y, y0)


# ------------------------------------------------------- ELL dispatches ----
@pytest.mark.parametrize("dispatch", ["fused", "loop"])
def test_engine_dispatch_matches_reference_and_ragged(dispatch):
    port, xs = _port(ell_dispatch=dispatch)
    ragged, _ = _port()
    ref, _ = _ref(ell_dispatch=dispatch)
    assert len(port.handle("g0").sclass.bands) > 1, "class must mix K"
    for k, x in xs.items():
        y = port.infer(k, x)
        assert torch.equal(y, ragged.infer(k, x))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref.infer(k, x)),
                                   **LOGIT_TOL)
    group = list(xs.items())
    for y, y0 in zip(port.serve_group(group), ragged.serve_group(group)):
        assert torch.equal(y, y0)
