"""Fault-tolerant checkpointing: sharded npz, atomic rename, async writes.

Port of ``repro.checkpoint.checkpoint`` with the same on-disk layout,
CRC32 per leaf and leaf keys: a tree of tensors (or numpy arrays) is
flattened in JAX's order and each leaf named by its JAX keypath
(``repro_torch.tree.flatten_with_path``, e.g. ``['w']/[0]``), so
a checkpoint written by either package restores into the other. Leaves
are copied to host numpy before ``save`` returns; ``restore`` gives
each leaf the device and dtype of the ``like`` tree's leaf.

Layout:  <dir>/step_<n>/arrays.npz + manifest.json + COMMITTED, written
to a ``.tmp-`` directory first and atomically renamed — a crash
mid-write can never corrupt the latest checkpoint. The ``COMMITTED``
marker is written (and fsync'd) only *after* the rename lands: a reader
— possibly a *different* CheckpointManager instance restoring while this
one is mid-save — treats any step directory without the marker as
in-flight and skips it, hiding a partially-visible directory on
filesystems where the rename is not atomic. The remaining list-then-read
window (a committed step rmtree'd for re-save between ``all_steps`` and
the read) is handled by ``restore_latest`` falling back to the next
committed step when the chosen one vanishes underneath it. Pre-marker
checkpoints (manifest but no marker at construction time) are
backfilled on init — safe because the old writer also renamed only
fully-written directories. ``latest_step`` scans committed directories
only. An async writer thread overlaps serialization with the next
training step (standard large-cluster practice); ``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, tree_unflatten

COMMIT_MARKER = "COMMITTED"


class ChecksumError(RuntimeError):
    """A restored array's CRC32 does not match its manifest entry —
    bit-rot or a torn write that still passed the npz container parse."""

    def __init__(self, step: int, key: str):
        super().__init__(
            f"checksum mismatch restoring step {step}, leaf {key!r}")
        self.step = step
        self.key = key


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree):
    flat = flatten_with_path(tree)
    return [k for k, _ in flat], [_host(v) for _, v in flat]


def _like(v: np.ndarray, ref):
    """``v`` as a leaf of the kind, dtype and device of ``ref``."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(v, copy=True)).to(
            device=ref.device, dtype=ref.dtype)
    return np.asarray(v, np.asarray(ref).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread = None
        self.events: list = []   # (kind, step) integrity/fallback records
        os.makedirs(directory, exist_ok=True)
        self._backfill_markers()

    def _backfill_markers(self):
        """Migrate pre-marker checkpoints: a step directory that already
        exists at construction time with a complete manifest was written
        by a writer that only renames fully-written directories, so it
        is committed data — stamp it. (An in-flight save from a live
        concurrent writer gets its marker ~instantly after the rename,
        so stamping early is harmless there too.)"""
        for d in os.listdir(self.dir):
            if not d.startswith("step_"):
                continue
            path = os.path.join(self.dir, d)
            if (os.path.exists(os.path.join(path, "manifest.json"))
                    and os.path.exists(os.path.join(path, "arrays.npz"))
                    and not os.path.exists(os.path.join(path, COMMIT_MARKER))):
                with open(os.path.join(path, COMMIT_MARKER), "w") as f:
                    f.write(json.dumps({"backfilled": True,
                                        "time": time.time()}))

    # ------------------------------------------------------------ save -----
    def save(self, step: int, tree, extra: dict = None):
        keys, vals = _flatten(tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, keys, vals, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, keys, vals, extra or {})

    def _write(self, step, keys, vals, extra):
        tmp = os.path.join(self.dir, f".tmp-step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": v for i, v in enumerate(vals)})
        crcs = [zlib.crc32(np.ascontiguousarray(v).tobytes()) for v in vals]
        manifest = {"step": step, "keys": keys, "time": time.time(),
                    "crc32": crcs, "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)                   # step_<n> vanishes here...
        os.rename(tmp, final)                      # ...and reappears here
        # Commit handshake: only a marker written AFTER the rename makes
        # the step visible to readers (other manager instances included).
        marker = os.path.join(final, COMMIT_MARKER)
        with open(marker, "w") as f:
            f.write(json.dumps({"step": step, "time": time.time()}))
            f.flush()
            os.fsync(f.fileno())
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------- restore -----
    def all_steps(self):
        """Steps with a complete COMMITTED handshake (manifest + marker).

        A directory missing the marker is an in-flight write from some
        manager instance (this one or another) — skipping it is what
        closes the restore-during-save race.
        """
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                if (os.path.exists(os.path.join(self.dir, d, "manifest.json"))
                        and os.path.exists(
                            os.path.join(self.dir, d, COMMIT_MARKER))):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (shape/dtype-checked)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        vals = [data[f"a{i}"] for i in range(len(manifest["keys"]))]
        # Integrity gate: every leaf must hash to its manifest CRC.
        # (Pre-CRC checkpoints carry no "crc32" key and skip the check.)
        for i, (k, v) in enumerate(zip(manifest["keys"], vals)):
            want = manifest.get("crc32", [])
            if i < len(want) and \
                    zlib.crc32(np.ascontiguousarray(v).tobytes()) != want[i]:
                raise ChecksumError(step, k)
        flat = flatten_with_path(like)
        if [k for k, _ in flat] != manifest["keys"]:
            raise ValueError("checkpoint/model structure mismatch")
        for v, (_, r) in zip(vals, flat):
            if tuple(v.shape) != tuple(r.shape):
                raise ValueError(f"leaf shape {v.shape} != {tuple(r.shape)}")
        leaves = [_like(v, r) for v, (_, r) in zip(vals, flat)]
        return tree_unflatten(like, leaves), manifest

    def restore_latest(self, like):
        """Restore the newest committed step, falling back to the next
        one if a concurrent re-save removed or clobbered it between
        listing and reading (the list-then-read window the marker can't
        cover), or if its arrays fail CRC verification (silent
        corruption after commit). Each fallback is recorded in
        ``self.events`` so the caller can surface it."""
        import zipfile

        for step in reversed(self.all_steps()):
            try:
                return self.restore(step, like)
            except ChecksumError:
                self.events.append(("checksum_fallback", step))
                continue
            except (OSError, zipfile.BadZipFile, json.JSONDecodeError):
                self.events.append(("unreadable_fallback", step))
                continue
        return None, None
