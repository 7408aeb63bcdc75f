"""Perf-trajectory file schema: writers for benchmarks, checker for lint.

Port of ``repro.analysis.static.bench_check``: the same schema, keys,
required metrics and messages, so either package's checker passes the
other's files. The port's provenance never imports JAX: it records
``jax_version`` "none" (which the schema allows) and, as ``backend``,
the torch device the run used ("cuda" or "cpu").

``BENCH_*.json`` files at the repo root record one benchmark run each so
re-anchors (and humans) can diff perf across PRs without re-running
anything. The schema is deliberately flat and tiny:

    {
      "bench":   "bench_spmm",           # which benchmark wrote it
      "schema":  2,                      # format version
      "created": "2026-08-08",           # ISO date of the run
      "command": "bench_spmm --smoke",   # how to reproduce
      "provenance": {                    # where the numbers came from
        "git_sha":     "b93d566...",     #   (schema 2: a trajectory
        "jax_version": "none",           #   point without its code +
        "backend":     "cuda"            #   runtime identity cannot be
      },                                 #   compared across PRs)
      "metrics": {"spmm.ragged_ms": 1.9, ...}   # flat str -> number
    }

``python -m repro_torch.analysis.static --bench-check [ROOT]`` (the
counterpart of ``lint_repro.py --bench-check``) fails the lint if a
committed trajectory file does not parse or violates this schema — a
malformed file is worse than no file, because a future regression gate
would silently skip it.
Schema 2 added the ``provenance`` block; ``write_bench_json`` collects
it automatically (best-effort fallbacks keep the writers dependency-
free), and schema-1 files fail the check until reseeded.
"""
from __future__ import annotations

import json
import numbers
import subprocess
from pathlib import Path
from typing import List

from repro_torch.analysis.static.report import Finding

SCHEMA_VERSION = 2

PROVENANCE_KEYS = ("git_sha", "jax_version", "backend")

# Per-bench required metric names (suffix-matched against the flat
# dotted keys): a trajectory file for that bench missing one of these
# regressed its reporting contract, not just its numbers. bench_spmm
# must carry the kernel-health trio the regression gates read.
REQUIRED_METRICS = {
    "bench_spmm": ("launches_per_spmm", "ell_pad_waste_x",
                   "achieved_roofline_frac"),
    "bench_serving": ("replica_speedup_x", "chaos_rescued", "chaos_shed"),
}


def flatten_metrics(obj, prefix: str = "") -> dict:
    """Collapse a nested results dict to flat dotted keys, numeric
    leaves only (bools and non-numeric leaves are dropped).

    >>> flatten_metrics({"a": {"b": 1.5, "note": "hi"}, "n": 3})
    {'a.b': 1.5, 'n': 3}
    """
    out: dict = {}
    if isinstance(obj, dict):
        for key, val in obj.items():
            dotted = f"{prefix}.{key}" if prefix else str(key)
            out.update(flatten_metrics(val, dotted))
    elif isinstance(obj, bool):
        pass
    elif isinstance(obj, numbers.Real):
        out[prefix] = obj
    return out


def collect_provenance(backend: str = None) -> dict:
    """Best-effort run provenance for a trajectory file.

    Every value is a non-empty string by construction — the schema
    check requires that, and a writer must never fail because git is
    unavailable ("unknown" records that honestly). ``jax_version`` is
    "none": the port runs without JAX. ``backend``: the torch device
    the run used (default: "cuda" where a card is present, else "cpu").
    """
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        sha = ""
    if not backend:
        import torch
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    return {"git_sha": sha or "unknown", "jax_version": "none",
            "backend": backend}


def write_bench_json(path, bench: str, command: str, created: str,
                     results: dict, *, backend: str = None) -> dict:
    """Flatten ``results`` and write a schema-2 trajectory file
    (provenance auto-collected; callers pass only the run facts and,
    where it is not the default, the device the run used)."""
    doc = {
        "bench": bench,
        "schema": SCHEMA_VERSION,
        "created": created,
        "command": command,
        "provenance": collect_provenance(backend),
        "metrics": flatten_metrics(results),
    }
    Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return doc


def check_bench_file(path) -> List[Finding]:
    """Validate one trajectory file against the schema."""
    path = Path(path)
    loc = str(path)

    def err(msg: str) -> Finding:
        return Finding("bench", "trajectory-schema", "error", loc, msg)

    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        return [err(f"unreadable or invalid JSON: {e}")]
    if not isinstance(doc, dict):
        return [err("top level must be an object")]
    findings: List[Finding] = []
    for key, typ in (("bench", str), ("created", str), ("command", str)):
        if not isinstance(doc.get(key), typ) or not doc.get(key):
            findings.append(err(f"missing or non-{typ.__name__} field "
                                f"{key!r}"))
    if doc.get("schema") != SCHEMA_VERSION:
        findings.append(err(f"schema must be {SCHEMA_VERSION}, "
                            f"got {doc.get('schema')!r}"))
    prov = doc.get("provenance")
    if not isinstance(prov, dict):
        findings.append(err("missing provenance object (schema 2: "
                            "git_sha / jax_version / backend)"))
    else:
        for key in PROVENANCE_KEYS:
            if not isinstance(prov.get(key), str) or not prov.get(key):
                findings.append(err(
                    f"provenance.{key} must be a non-empty string, "
                    f"got {prov.get(key)!r}"))
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        findings.append(err("metrics must be a non-empty object"))
    else:
        for key, val in metrics.items():
            if not isinstance(key, str):
                findings.append(err(f"metric key {key!r} is not a string"))
            if isinstance(val, bool) or not isinstance(val, numbers.Real):
                findings.append(
                    err(f"metric {key!r} must be a number, got {val!r}"))
        for want in REQUIRED_METRICS.get(doc.get("bench"), ()):
            if not any(isinstance(k, str) and k.split(".")[-1] == want
                       for k in metrics):
                findings.append(err(
                    f"bench {doc.get('bench')!r} must report a "
                    f"{want!r} metric (reporting contract regressed)"))
    return findings


def check_bench_files(root) -> List[Finding]:
    """Validate every BENCH_*.json under ``root`` (non-recursive)."""
    root = Path(root)
    findings: List[Finding] = []
    for path in sorted(root.glob("BENCH_*.json")):
        findings.extend(check_bench_file(path))
    return findings
