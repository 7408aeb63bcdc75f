"""The program's own spans of a traced run, for the per-layer metrics.

``repro_torch`` records, while its tracer is on, each dispatch's device
segments (category ``device_segment``: ``stage``, then per layer ``xw``,
``dense``, ``ell``, ``coo``, ``out``, on the tracer's clock through its
CUDA clock anchor), each dispatch's ``enqueue`` host span, each batch's
``slot_wait`` for an in-flight slot, and the phases of
``Engine.register`` (``GraphHandle.phases``). This module reads them
once a run and hands the readers under ``metrics/`` what they need. A
program without them (an older commit) gives nothing: every function
returns None, and none raises. A ring that wrapped gives nothing either,
with a note.
"""
from __future__ import annotations

import bisect
import statistics

from hgcn_bench import yardstick

SEGMENT_CAT = "device_segment"
SEGMENTS = ("stage", "xw", "dense", "ell", "coo", "out")


def _read(ctx):
    """{"dispatches": {chain: row}, "host": {name: [(t0, s, args)]}},
    computed once a run; None without a tracer or where its ring
    wrapped."""
    if "_devtrace" in ctx.__dict__:
        return ctx._devtrace
    ctx._devtrace = None
    tr = ctx.tracer
    if tr is None:
        return None
    if tr.wrapped():
        ctx.notes.append("devtrace: the tracer's ring wrapped; the span "
                         "metrics are left out")
        return None
    begins, chains, host = {}, {}, {}
    for e in tr.events():
        if e["ph"] == "B":
            begins[e["sid"]] = e
        elif e["ph"] == "E" and e["sid"] in begins:
            b = begins.pop(e["sid"])
            t0, t1, args = b["ts"], e["ts"], b["args"] or {}
            if b["cat"] == SEGMENT_CAT and "chain" in args:
                row = chains.setdefault(args["chain"], {
                    "live": args["live"], "enqueued": args["enqueued"],
                    "by": dict.fromkeys(SEGMENTS, 0.0), "first": None,
                    "last": None, "staged": []})
                if b["name"] in row["by"]:
                    row["by"][b["name"]] += t1 - t0
                if args.get("prepared"):
                    row["staged"].append((t0, t1))
                else:
                    row["first"] = t0 if row["first"] is None \
                        else min(row["first"], t0)
                    row["last"] = t1 if row["last"] is None \
                        else max(row["last"], t1)
            else:
                host.setdefault(b["name"], []).append((t0, t1 - t0, args))
    ctx._devtrace = {"dispatches": chains, "host": host}
    return ctx._devtrace


def dispatches(ctx) -> list:
    """The rows of the dispatches enqueued inside the window that ran a
    whole chain; None where the program recorded none."""
    got = _read(ctx)
    if got is None:
        return None
    w = ctx.win
    rows = [r for r in got["dispatches"].values()
            if r["first"] is not None
            and w.t_start <= r["enqueued"] <= w.t_end]
    return rows or None


def dev_ms(ctx, segment: str):
    """Device ms a request of one segment: its sum over the window's
    dispatches over their live requests. Notes once a run the six
    segments' sum against the union of the dispatches' intervals, and
    the share of dispatches with a staged pair that interleaved with
    another dispatch's chain."""
    rows = dispatches(ctx)
    if rows is None:
        return None
    live = sum(r["live"] for r in rows)
    if "_devtrace_noted" not in ctx.__dict__:
        ctx._devtrace_noted = True
        ctx.notes.append(_cover_note(ctx, rows, live))
    return 1e3 * sum(r["by"][segment] for r in rows) / live


def _cover_note(ctx, rows, live) -> str:
    total = sum(sum(r["by"].values()) for r in rows)
    iv = [(r["first"], r["last"]) for r in rows]
    iv += [p for r in rows for p in r["staged"]]
    lo = min(a for a, _ in iv)
    hi = max(b for _, b in iv)
    union = yardstick.union_s(iv, lo, hi)
    # one stream runs the chains one after another: a staged pair meets
    # another chain only if the last chain to begin before its end does,
    # or the one before that where the last is its own
    chains = sorted((r["first"], r["last"], k) for k, r in enumerate(rows))
    firsts = [c[0] for c in chains]
    mixed = 0
    for k, r in enumerate(rows):
        for p0, p1 in r["staged"]:
            i = bisect.bisect_left(firsts, p1) - 1
            if any(a < p1 and p0 < b and j != k
                   for a, b, j in chains[max(i - 1, 0):i + 1]):
                mixed += 1
                break
    note = (f"devtrace: {len(rows)} dispatches, {live} requests enqueued "
            f"in the window; segments {1e3 * total / live!r} ms a request, "
            f"their union {1e3 * union / live!r} ms a request; "
            f"{mixed} of {len(rows)} dispatches with a staged pair inside "
            f"another dispatch's chain")
    dc = getattr(ctx.tracer, "device_clock", None)
    if dc is not None:
        drift, span = dc.drift_s()
        note += (f"; clock anchor drift {drift * 1e3!r} ms over {span!r} s "
                 f"(anchor read within {dc.spread_s * 1e3!r} ms)")
    return note


def per_request_ms(ctx, value) -> list:
    """``value(row)`` in ms once for each live request of the window's
    dispatches; None where there are none."""
    rows = dispatches(ctx)
    if rows is None:
        return None
    return [1e3 * value(r) for r in rows for _ in range(r["live"])]


def host_spans(ctx, name: str) -> list:
    """(begin, seconds, args) of the host spans ``name`` begun inside
    the window; None where there are none."""
    got = _read(ctx)
    if got is None:
        return None
    w = ctx.win
    rows = [s for s in got["host"].get(name, ())
            if w.t_start <= s[0] <= w.t_end]
    return rows or None


def median_or_none(values):
    return statistics.median(values) if values else None


def register_phase_s(ctx, phase: str):
    """Host seconds of one phase of ``Engine.register`` on the run's
    graph (``GraphHandle.phases``)."""
    s = ctx.sess
    phases = getattr(getattr(s, "handle", None), "phases", None)
    if not phases or phase not in phases:
        return None
    return float(phases[phase])


def on_card(ctx) -> bool:
    return ctx.sess is not None and ctx.sess.device.type == "cuda"
