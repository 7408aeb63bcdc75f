"""Chrome-trace / Perfetto JSON export.

Port of ``repro.obs.export``; pure Python.

Converts the tracer's raw B/E/i event stream into the Chrome trace
event format (the JSON flavor Perfetto's UI and `chrome://tracing`
both load). Spans are assembled offline into complete ``"X"`` events —
begin timestamp + duration — which is what makes cross-thread spans
work: a span begun on a staging worker and ended on the drainer still
renders as one box, on the *beginning* thread's track.

Track layout:

- ``pid 1`` — the host process; one track per real thread (tid), named
  from the live thread table when available.
- ``pid 2 / tid 1`` — the virtual **device window** track: every span
  with ``cat == "device"`` lands here regardless of which host thread
  opened it, so staging/compute overlap is visually checkable by
  stacking the device track against the host tracks.
- ``pid 2 / tid 1+r`` — multi-replica traces: a device span whose
  begin args carry ``"replica": r`` lands on its own per-replica
  device track (``device[r]``), so 4-replica runs render four stacked
  device timelines and cross-replica overlap is visually checkable.

Timestamps are microseconds relative to the earliest event (Chrome
format convention). The source clock is whatever the tracer was built
with — ``SimClock`` traces export virtual time, which is exactly what
the deterministic smoke asserts against.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

DEVICE_PID = 2
DEVICE_TID = 1
HOST_PID = 1


def _thread_names() -> Dict[int, str]:
    """Best-effort ident → name map for live threads."""
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def chrome_trace(events: List[dict], *, metadata: Optional[dict] = None,
                 thread_names: Optional[Dict[int, str]] = None) -> dict:
    """Assemble raw tracer events into a Chrome-trace document.

    ``events`` is ``Tracer.events()`` output. Unclosed spans export as
    zero-duration ``X`` events flagged ``{"unclosed": true}`` so the
    completeness checker (and a human in Perfetto) can see them; end
    events whose begin fell off the ring are counted in
    ``otherData.orphan_ends``.
    """
    names = dict(thread_names or {})
    for tid, name in _thread_names().items():
        names.setdefault(tid, name)

    begins: Dict[int, dict] = {}
    ends: Dict[int, dict] = {}
    instants: List[dict] = []
    orphan_ends = 0
    for ev in events:
        if ev["ph"] == "B":
            begins[ev["sid"]] = ev
        elif ev["ph"] == "E":
            ends[ev["sid"]] = ev
        else:
            instants.append(ev)
    for sid in ends:
        if sid not in begins:
            orphan_ends += 1

    t0 = min((ev["ts"] for ev in events), default=0.0)

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    out: List[dict] = []
    host_tids = set()
    device_tids = {DEVICE_TID: "device window"}

    def track(ev: dict):
        if ev["cat"] == "device":
            replica = (ev["args"] or {}).get("replica", -1)
            if isinstance(replica, int) and replica >= 0:
                tid = DEVICE_TID + replica
                device_tids[tid] = f"device[{replica}]"
                return DEVICE_PID, tid
            return DEVICE_PID, DEVICE_TID
        host_tids.add(ev["tid"])
        return HOST_PID, ev["tid"]

    for sid, b in sorted(begins.items()):
        e = ends.get(sid)
        args = dict(b["args"] or {})
        if e is not None:
            args.update(e["args"] or {})
            dur = max(0.0, us(e["ts"]) - us(b["ts"]))
        else:
            args["unclosed"] = True
            dur = 0.0
        args.update(sid=sid, parent=b["parent"], req=b["req"])
        pid, tid = track(b)
        out.append({"ph": "X", "name": b["name"], "cat": b["cat"] or "span",
                    "pid": pid, "tid": tid, "ts": us(b["ts"]), "dur": dur,
                    "args": args})
    for ev in instants:
        args = dict(ev["args"] or {})
        args.update(sid=ev["sid"], parent=ev["parent"], req=ev["req"])
        pid, tid = track(ev)
        out.append({"ph": "i", "s": "t", "name": ev["name"],
                    "cat": ev["cat"] or "instant", "pid": pid, "tid": tid,
                    "ts": us(ev["ts"]), "args": args})

    meta_events = [
        {"ph": "M", "name": "process_name", "pid": HOST_PID, "tid": 0,
         "args": {"name": "host"}},
        {"ph": "M", "name": "process_name", "pid": DEVICE_PID, "tid": 0,
         "args": {"name": "device"}},
    ]
    for tid in sorted(device_tids):
        meta_events.append(
            {"ph": "M", "name": "thread_name", "pid": DEVICE_PID,
             "tid": tid, "args": {"name": device_tids[tid]}})
    for k, tid in enumerate(sorted(host_tids)):
        meta_events.append(
            {"ph": "M", "name": "thread_name", "pid": HOST_PID, "tid": tid,
             "args": {"name": names.get(tid, f"thread-{k}")}})

    other = dict(metadata or {})
    other["orphan_ends"] = orphan_ends
    return {"traceEvents": meta_events + out,
            "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(path: str, tracer, *,
                       metadata: Optional[dict] = None) -> dict:
    """Export ``tracer``'s ring to a Perfetto-loadable JSON file.

    Records ring capacity and whether the ring wrapped (dropped old
    events) in ``otherData`` — a wrapped trace can still be viewed but
    fails ``trace_report.py --assert-complete``.
    """
    other = dict(metadata or {})
    other["ring_capacity"] = tracer.capacity
    other["ring_wrapped"] = tracer.wrapped()
    doc = chrome_trace(tracer.events(), metadata=other)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
