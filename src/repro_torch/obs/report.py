"""Offline critical-path analysis over an exported Chrome trace.

Everything here operates on the JSON document written by
``repro_torch.obs.export.write_chrome_trace`` — spans alone, no access
to the live process — so the numbers it reproduces (per-stage
percentiles, overlap ratio, padded-MAC waste) are an independent
cross-check of the aggregate counters the server reports. Port of
``repro.obs.report``; tests import it directly. Run as a module it is
the port's ``scripts/trace_report.py``:

    python -m repro_torch.obs.report TRACE.json [--assert-complete]
                                     [--json OUT]

prints the report of one exported trace; ``--assert-complete`` exits 1
unless every per-request span tree is closed and the span-measured
overlap ratio lands within 10% of the one the pipeline reported, and
``--json`` also writes the analysis bundle.

Span taxonomy (see docs/TRACING.md):

- per-request: ``request`` (root, submit → future resolution; rejected
  submissions get an immediately-closed root with the reject reason)
  and ``queue`` (child; submit → batch-plan close, close reason in
  args).
- per-batch (``args.reqs`` lists the member request ids): ``staging``,
  ``turnstile``, ``dispatch`` (serial), ``device`` (the virtual device
  window; carries ``padded``/``live``/``sclass``/``reason``/``cold``),
  ``wait_device`` (drainer blocked on completion; child of its device
  span).
- instants: cache hit/miss, compile_cold, lifecycle retire/defer,
  autotune sweeps.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.obs.metrics import percentile

# Stages a request's wall time is attributed to. Batch-scoped stages
# attribute their full duration to every member (members share the
# batch; the report is per-request attribution, not an accounting
# identity).
STAGES = ("queue", "staging", "turnstile", "dispatch", "device",
          "wait_device")

# |measured − reported| tolerance for the overlap cross-check: 10%
# relative (the acceptance bar) with a small absolute floor so
# near-zero ratios don't demand impossible relative precision.
OVERLAP_REL_TOL = 0.10
OVERLAP_ABS_FLOOR = 0.02


def load_trace(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def spans(doc: dict) -> List[dict]:
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def instants(doc: dict) -> List[dict]:
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "i"]


def check_complete(doc: dict) -> List[str]:
    """Structural problems in the trace; empty list == complete.

    Complete means: the ring never wrapped, every span closed, every
    parent link resolves, every request id seen anywhere (span ``req``
    tags or batch ``reqs`` membership) has exactly one closed
    ``request`` root span.
    """
    problems: List[str] = []
    other = doc.get("otherData", {})
    if other.get("ring_wrapped"):
        problems.append("ring wrapped: oldest events were dropped")
    if other.get("orphan_ends"):
        problems.append(f"{other['orphan_ends']} span end(s) without a begin")

    xs = spans(doc)
    sids = {s["args"]["sid"] for s in xs}
    roots: Dict[int, int] = {}
    seen_reqs = set()
    for s in xs:
        a = s["args"]
        if a.get("unclosed"):
            problems.append(f"unclosed span: {s['name']} (sid={a['sid']})")
        if a.get("parent", -1) >= 0 and a["parent"] not in sids:
            problems.append(
                f"orphan span: {s['name']} (sid={a['sid']}) "
                f"parent {a['parent']} not in trace")
        req = a.get("req", -1)
        if req != -1:
            seen_reqs.add(req)
            if s["name"] == "request":
                roots[req] = roots.get(req, 0) + 1
        for r in a.get("reqs", []) or []:
            seen_reqs.add(r)
    for ev in instants(doc):
        a = ev.get("args", {})
        if a.get("parent", -1) >= 0 and a["parent"] not in sids:
            problems.append(
                f"orphan instant: {ev['name']} parent {a['parent']} "
                "not in trace")
    for req in sorted(seen_reqs):
        n = roots.get(req, 0)
        if n != 1:
            problems.append(
                f"request {req}: {n} 'request' root span(s), expected 1")
    return problems


def stage_table(doc: dict) -> Dict[str, dict]:
    """Per-stage sample count + p50/p99 in ms across the whole trace."""
    durs: Dict[str, List[float]] = {st: [] for st in STAGES}
    for s in spans(doc):
        if s["name"] in durs:
            durs[s["name"]].append(s["dur"] / 1e3)  # µs → ms
    return {
        st: {"n": len(v),
             "p50_ms": percentile(v, 50),
             "p99_ms": percentile(v, 99)}
        for st, v in durs.items() if v
    }


def per_request(doc: dict) -> Dict[int, dict]:
    """Per-request stage attribution + dominant stage.

    Request-scoped spans attribute by ``req`` tag; batch-scoped spans
    attribute their full duration to every member in ``args.reqs``.
    Rejected submissions (negative synthetic ids) have no stages and
    are skipped here — they show up in ``check_complete`` only.
    """
    out: Dict[int, dict] = {}
    for s in spans(doc):
        a = s["args"]
        req = a.get("req", -1)
        if s["name"] == "request" and req >= 0:
            rec = out.setdefault(req, {"total_ms": 0.0, "stages": {}})
            rec["total_ms"] = s["dur"] / 1e3
        members = [req] if (s["name"] in STAGES and req >= 0) else []
        if s["name"] in STAGES:
            members = members or [r for r in (a.get("reqs") or []) if r >= 0]
        for r in members:
            rec = out.setdefault(r, {"total_ms": 0.0, "stages": {}})
            st = rec["stages"]
            st[s["name"]] = st.get(s["name"], 0.0) + s["dur"] / 1e3
    for rec in out.values():
        rec["dominant"] = (max(rec["stages"], key=rec["stages"].get)
                           if rec["stages"] else None)
    return out


def dominant_hist(doc: dict) -> Dict[str, int]:
    hist: Dict[str, int] = {}
    for rec in per_request(doc).values():
        if rec["dominant"] is not None:
            hist[rec["dominant"]] = hist.get(rec["dominant"], 0) + 1
    return hist


def measured_overlap(doc: dict) -> dict:
    """Overlap ratio recomputed from spans alone.

    Mirrors ``ServerStats.overlap_ratio``: for every device-window span
    with a ``wait_device`` child, the host was blocked for
    ``min(wait, device)`` of that window;
    ``overlap = 1 − Σ min(wait, dev) / Σ dev``. Returns the ratio plus
    the totals so the CLI can show its work.
    """
    waits: Dict[int, float] = {}
    for s in spans(doc):
        if s["name"] == "wait_device":
            waits[s["args"].get("parent", -1)] = s["dur"]
    dev_total = 0.0
    wait_total = 0.0
    n = 0
    for s in spans(doc):
        if s["name"] != "device":
            continue
        sid = s["args"]["sid"]
        if sid not in waits:
            continue
        dev_total += s["dur"]
        wait_total += min(waits[sid], s["dur"])
        n += 1
    ratio = (1.0 - wait_total / dev_total) if dev_total > 0 else 0.0
    return {"ratio": ratio, "batches": n,
            "device_total_ms": dev_total / 1e3,
            "wait_total_ms": wait_total / 1e3}


def overlap_check(doc: dict) -> dict:
    """Cross-check measured overlap against the pipeline's own numbers.

    The exporter embeds the pipeline snapshot (``overlap_ewma`` — the
    EWMA driving adaptive ``max_inflight``) and the serving snapshot
    (``overlap_ratio`` — the cumulative ratio) in ``otherData``; the
    span-measured ratio must land within 10% of the cumulative ratio.
    """
    measured = measured_overlap(doc)
    other = doc.get("otherData", {})
    reported = (other.get("serving") or {}).get("overlap_ratio")
    ewma = (other.get("pipeline") or {}).get("overlap_ewma")
    ok = True
    if reported is not None and measured["batches"] > 0:
        tol = max(OVERLAP_REL_TOL * abs(reported), OVERLAP_ABS_FLOOR)
        ok = abs(measured["ratio"] - reported) <= tol
    return {"measured": measured["ratio"], "reported": reported,
            "ewma": ewma, "batches": measured["batches"], "ok": ok}


def waste_by_class(doc: dict) -> Dict[str, dict]:
    """Padded-MAC waste per shape class, from device-span pad args."""
    out: Dict[str, dict] = {}
    for s in spans(doc):
        if s["name"] not in ("device", "dispatch"):
            continue
        a = s["args"]
        if "padded" not in a:
            continue
        sclass = str(a.get("sclass", "?"))
        rec = out.setdefault(sclass, {"batches": 0, "live": 0, "padded": 0})
        rec["batches"] += 1
        rec["live"] += a.get("live", 0)
        rec["padded"] += a["padded"]
    for rec in out.values():
        rec["waste_frac"] = (1.0 - rec["live"] / rec["padded"]
                             if rec["padded"] else 0.0)
    return out


def report(doc: dict) -> dict:
    """The full analysis bundle for one trace document."""
    reqs = per_request(doc)
    return {
        "problems": check_complete(doc),
        "requests": len([r for r in reqs if r >= 0]),
        "stage_table": stage_table(doc),
        "dominant": dominant_hist(doc),
        "overlap": overlap_check(doc),
        "waste": waste_by_class(doc),
    }


def format_report(rep: dict) -> str:
    lines: List[str] = []
    lines.append(f"requests traced: {rep['requests']}")
    if rep["stage_table"]:
        lines.append("per-stage latency (ms):")
        lines.append(f"  {'stage':<12}{'n':>6}{'p50':>10}{'p99':>10}")
        for st, row in rep["stage_table"].items():
            lines.append(f"  {st:<12}{row['n']:>6}"
                         f"{row['p50_ms']:>10.3f}{row['p99_ms']:>10.3f}")
    if rep["dominant"]:
        dom = ", ".join(f"{k}={v}" for k, v in
                        sorted(rep["dominant"].items(),
                               key=lambda kv: -kv[1]))
        lines.append(f"dominant stage: {dom}")
    ov = rep["overlap"]
    if ov["batches"]:
        rep_s = ("n/a" if ov["reported"] is None
                 else f"{ov['reported']:.3f}")
        ewma_s = "n/a" if ov["ewma"] is None else f"{ov['ewma']:.3f}"
        lines.append(
            f"overlap: measured={ov['measured']:.3f} reported={rep_s} "
            f"ewma={ewma_s} ({'OK' if ov['ok'] else 'MISMATCH'})")
    for sclass, rec in sorted(rep["waste"].items()):
        lines.append(
            f"pad waste [{sclass}]: {rec['live']}/{rec['padded']} live "
            f"({rec['waste_frac']:.1%} wasted, {rec['batches']} batches)")
    if rep["problems"]:
        lines.append("INCOMPLETE TRACE:")
        lines.extend(f"  - {p}" for p in rep["problems"])
    else:
        lines.append("trace complete: all span trees closed")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Critical-path report over an exported serving trace.")
    ap.add_argument("trace", help="Chrome-trace JSON file to analyze")
    ap.add_argument("--assert-complete", action="store_true",
                    help="exit 1 on incomplete span trees or an overlap "
                         "mismatch beyond 10%%")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the analysis bundle as JSON")
    args = ap.parse_args(argv)

    rep = report(load_trace(args.trace))
    print(format_report(rep))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rep, fh, indent=1, sort_keys=True)
    if args.assert_complete:
        if rep["problems"]:
            print(f"FAIL: {len(rep['problems'])} completeness problem(s)",
                  file=sys.stderr)
            return 1
        if not rep["overlap"]["ok"]:
            print("FAIL: span-measured overlap disagrees with the "
                  "pipeline's reported ratio by more than 10%",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
