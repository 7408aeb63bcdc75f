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

Sharded state (``spec_tree=`` and ``mesh=``): the port's leaves are a
rank's blocks, which do not know their layout, so the caller names it,
as for ``sharding.shard_tree``. ``save`` then writes global arrays, as
the reference does for a GSPMD array: leaf by leaf, each block that no
other rank also holds goes to the mesh's first rank (one ``send`` /
``recv`` a block), which assembles the leaf in host memory; a rank's
device holds its state plus one block at a time. The gather is
collective (every rank of the mesh calls ``save``) and ends before
``save`` returns; only the first rank writes, and ``wait()`` returns on
every rank once the step is committed. ``restore`` reads the global
arrays and cuts each to this rank's block of ``mesh`` (``fit_spec`` +
``local_slice``, as ``launch.elastic`` does), so a state saved on one
mesh restores on any other, and into the reference's manager whole.
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
import torch.distributed as dist

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


def _owners(spec, mesh, ranks) -> list:
    """The ranks of ``ranks`` holding the distinct blocks of a leaf under
    ``spec``: those at coordinate 0 on every axis the spec does not
    split over."""
    from repro_torch.launch.mesh import axis_names, coordinates

    split = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    rest = [a for a in axis_names(mesh) if a not in split]
    return [r for r in ranks
            if all(coordinates(mesh, r)[a] == 0 for a in rest)]


def _gather_to_host(tree, spec_tree, mesh):
    """(keys, the global leaves as numpy on the mesh's first rank, else
    None, the mesh's group): each leaf's distinct blocks sent to the
    first rank one at a time and written at their slices of a host
    array. Collective over the mesh."""
    from repro_torch.distributed.sharding import (_full_shape, _specs_like,
                                                  local_slice)
    from repro_torch.launch.mesh import all_axes, axes_group

    leaves, specs = _specs_like(tree, spec_tree)
    keys = [k for k, _ in flatten_with_path(tree)]
    group = axes_group(mesh, all_axes(mesh))
    ranks = dist.get_process_group_ranks(group)
    me, first = dist.get_rank(), ranks[0]
    vals = [] if me == first else None
    for leaf, spec in zip(leaves, specs):
        if not isinstance(leaf, torch.Tensor):
            if vals is not None:
                vals.append(_host(leaf))               # whole on every rank
            continue
        shape = _full_shape(spec, tuple(leaf.shape), mesh)
        if me != first:
            if me in _owners(spec, mesh, ranks):
                dist.send(leaf.contiguous(), dst=first, group=group)
            continue
        full = np.empty(shape, dtype=_host(leaf.new_empty(0)).dtype)
        buf = None
        for r in _owners(spec, mesh, ranks):
            if r == first:
                block = leaf
            else:
                if buf is None:
                    buf = torch.empty_like(leaf, memory_format=(
                        torch.contiguous_format))
                dist.recv(buf, src=r, group=group)
                block = buf
            full[local_slice(spec, shape, mesh, r)] = _host(block)
        del buf
        vals.append(full)
    return keys, vals, group


def _blocks(vals, like, spec_tree, mesh) -> list:
    """Each global array cut to this rank's block of ``mesh``."""
    from repro_torch.distributed.sharding import (_specs_like, fit_spec,
                                                  local_slice)

    _, specs = _specs_like(like, spec_tree)
    me = dist.get_rank()
    out = []
    for v, spec in zip(vals, specs):
        spec = fit_spec(spec, tuple(v.shape), mesh)
        out.append(np.asarray(v[local_slice(spec, tuple(v.shape), mesh,
                                            me)]))
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread = None
        self._group = None       # the mesh of a sharded save in flight
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
    def save(self, step: int, tree, extra: dict = None, *, spec_tree=None,
             mesh=None):
        """Write ``tree`` as step ``step`` (async unless ``async_save`` is
        off). ``spec_tree`` and ``mesh``: ``tree`` holds this rank's
        blocks of ``mesh`` under ``spec_tree``; the global arrays are
        written (collective over the mesh, see the module's docstring)."""
        group = None
        if spec_tree is None:
            keys, vals = _flatten(tree)
        else:
            self.wait()                 # the last step committed everywhere
            keys, vals, group = _gather_to_host(tree, spec_tree, mesh)
        if vals is not None:            # this rank writes
            if self.async_save:
                self.wait()
                self._thread = threading.Thread(
                    target=self._write, args=(step, keys, vals, extra or {}),
                    daemon=True)
                self._thread.start()
            else:
                self._write(step, keys, vals, extra or {})
        self._group = group
        if group is not None and not self.async_save:
            self.wait()

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
        """Join the writer; after a sharded save, on every rank of its
        mesh (collective), once the step is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._group is not None:
            group, self._group = self._group, None
            dist.barrier(group=group)

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

    def restore(self, step: int, like, *, spec_tree=None, mesh=None):
        """Restore into the structure of ``like`` (shape/dtype-checked).
        ``spec_tree`` and ``mesh``: each global array cut to this rank's
        block of ``mesh`` under its spec (fitted to the array's shape),
        ``like`` holding this rank's blocks."""
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
        if spec_tree is not None:
            vals = _blocks(vals, like, spec_tree, mesh)
        for v, (_, r) in zip(vals, flat):
            if tuple(v.shape) != tuple(r.shape):
                raise ValueError(f"leaf shape {v.shape} != {tuple(r.shape)}")
        leaves = [_like(v, r) for v, (_, r) in zip(vals, flat)]
        return tree_unflatten(like, leaves), manifest

    def restore_latest(self, like, *, spec_tree=None, mesh=None):
        """Restore the newest committed step, falling back to the next
        one if a concurrent re-save removed or clobbered it between
        listing and reading (the list-then-read window the marker can't
        cover), or if its arrays fail CRC verification (silent
        corruption after commit). Each fallback is recorded in
        ``self.events`` so the caller can surface it."""
        import zipfile

        for step in reversed(self.all_steps()):
            try:
                return self.restore(step, like, spec_tree=spec_tree,
                                    mesh=mesh)
            except ChecksumError:
                self.events.append(("checksum_fallback", step))
                continue
            except (OSError, zipfile.BadZipFile, json.JSONDecodeError):
                self.events.append(("unreadable_fallback", step))
                continue
        return None, None
