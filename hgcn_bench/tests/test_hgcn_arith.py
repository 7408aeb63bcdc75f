"""The yardstick's arithmetic on hand-worked cases: the SpMM roofline
and the GCN FLOP count, percentiles and due-time latencies on a fixed
schedule, the busy share, the arrival schedule."""
import math

import numpy as np
import pytest

from hgcn_bench import cell, traffic, yardstick


def test_spmm_work_and_bound_on_a_hand_worked_csr():
    # 3 x 3, 5 nonzeros, F = 2: values + indices 5 * 8, row pointers
    # 4 * 4, B 3 * 2 * 4, Y 3 * 2 * 4 bytes; 2 * 5 * 2 FLOPs
    nbytes, flops = yardstick.spmm_work(3, 3, 5, 2)
    assert nbytes == 40 + 16 + 24 + 24
    assert flops == 20
    assert yardstick.bound_s(nbytes, flops) == pytest.approx(
        104 / yardstick.PEAK_HBM_BYTES)
    assert yardstick.bound_s(1.0, 67e12) == pytest.approx(1.0)


def test_gcn_request_flops():
    # N = 10, nnz = 30, F_in = 4, H = 3, C = 2
    want = 2 * 10 * 4 * 3 + 2 * 30 * 3 + 2 * 10 * 3 * 2 + 2 * 30 * 2
    assert yardstick.gcn_request_flops(10, 30, 4, 3, 2) == want
    reddit = yardstick.gcn_request_flops(232965, 12010508, 602, 128, 41)
    assert 42e9 < reddit < 43e9


def test_percentiles_by_nearest_rank_with_failures_last():
    vals = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert yardstick.percentile(vals, 50) == 3.0
    assert yardstick.percentile(vals, 95) == 5.0
    assert yardstick.percentile(list(range(1, 101)), 95) == 95
    assert yardstick.percentile(vals + [math.inf], 95) == math.inf
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)


def test_latencies_run_from_the_due_time_on_a_fixed_schedule():
    win = cell.Window("open")
    win.t_start, win.t_end = 10.0, 20.0
    # due, submitted late, done; one failure; one due before the window
    win.records = [
        {"due": 10.5, "submit": 10.6, "done": 10.9, "ok": True},
        {"due": 12.0, "submit": 12.0, "done": 12.1, "ok": True},
        {"due": 19.9, "submit": 19.9, "done": 21.0, "ok": True},
        {"due": 15.0, "submit": 15.0, "done": 15.5, "ok": False},
        {"due": 9.0, "submit": 9.0, "done": 10.2, "ok": True},
    ]
    ctx = cell.Context(None, None, win, 0.0)
    lat = ctx.latencies_ms()
    assert lat[:3] == pytest.approx([400.0, 100.0, 1100.0])
    assert lat[3] == math.inf and len(lat) == 4
    assert yardstick.percentile(lat, 50) == pytest.approx(400.0)


def test_closed_loop_counts_what_resolves_inside_the_window():
    win = cell.Window("closed")
    win.t_start, win.t_end = 0.0, 1.0
    win.records = [{"due": -0.5, "done": 0.2, "ok": True},
                   {"due": 0.5, "done": 1.5, "ok": True},
                   {"due": 0.1, "done": None, "ok": None}]
    assert win.counted() == win.records[:1]


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (-1.0, 0.2)]
    assert yardstick.union_s(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert yardstick.union_s(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert yardstick.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


MIX = {"loop": "open", "rate_per_s": 50.0, "schedule_seed": 0,
       "warmup_s": 1.0, "deadline_ms": 100, "target_batch": 4,
       "max_inflight": 2, "snapshots": 8, "feature_density": 0.05,
       "sample": 4}


def test_every_seed_gets_the_same_arrivals_rotated():
    a = traffic.arrivals(MIX, 1, 20.0)
    b = traffic.arrivals(MIX, 2 ** 31 + 17, 20.0)
    assert len(a) == len(b) and 900 < len(a) < 1100
    assert np.all(np.diff(a) >= 0) and a[-1] <= 20.0 and b[-1] <= 20.0
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0.0)),
                               np.sort(np.diff(b, prepend=0.0)))
    assert not np.allclose(a, b)
    ga, gb = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
    k = int(np.argmin([np.abs(np.roll(ga, -i) - gb).max()
                       for i in range(len(ga))]))
    np.testing.assert_allclose(np.roll(ga, -k), gb)
    np.testing.assert_array_equal(a, traffic.arrivals(MIX, 1, 20.0))


def test_a_shorter_windows_gaps_are_a_longer_ones_first():
    short, long = traffic.gaps(MIX, 10.0), traffic.gaps(MIX, 51.0)
    assert 400 < len(short) < len(long)
    np.testing.assert_array_equal(short, long[: len(short)])
    other = traffic.gaps(dict(MIX, schedule_seed=1), 10.0)
    assert not np.array_equal(other[:100], short[:100])


def test_check_names_what_a_mix_lacks():
    traffic.check(MIX)
    bad = dict(MIX)
    del bad["rate_per_s"]
    with pytest.raises(ValueError, match="rate_per_s"):
        traffic.check(bad)
    with pytest.raises(ValueError, match="loop"):
        traffic.check(dict(MIX, loop="burst"))


def test_reservoir_keeps_k_and_the_last_from_the_seed():
    def run(seed):
        r = traffic.Reservoir(3, seed)
        for i in range(100):
            r.offer(i)
        return r.items()
    a = run(7)
    assert len(a) == 4 and a[-1] == 99 and a == run(7)
    assert run(8) != a
    small = traffic.Reservoir(5, 1)
    small.offer("x")
    assert small.items() == ["x"]
