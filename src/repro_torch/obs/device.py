"""Device spans of the served forward, on the tracer's clock.

The port's addition to the tracer (``obs/trace.py``): where the
``device`` span times a dispatch from enqueue to drain on the host, a
``DeviceChain`` times what the card ran. While a tracer is enabled,
``Engine.serve_group_async`` records a CUDA event on the stream at each
engine boundary of the forward; consecutive boundaries share their
event, so the segments tile the dispatch's device interval exactly:

  stage   the features' permutation gather, padding and group stack
  xw      X·W of one layer (``member_matmul``; a GAT's scores with it)
  attn    a GAT layer's row statistics and edge coefficients
  dense   the dense-tile engine (``dense_tiles_matmul``)
  ell     the ELL engine and its sum onto the dense engine's rows
  coo     the COO engine and its add
  out     the layer's slice, type and activation; after the last layer
          also the unpadding and the inverse permutation

``Engine.prepare_x`` (run ahead on the pipeline's staging worker) times
its own ``stage`` pair. The pipeline resolves a chain where it already
waits for the dispatch (``DispatchPipeline._finish``, the serial
frontend after its completion hook) and writes each segment as a span
of category ``SEGMENT_CAT``, parented on the dispatch's ``device`` span.

``DeviceClock`` puts CUDA events on the tracer's host clock: an anchor
event whose host time is read at attach, and a second anchor at export
that measures the drift between the two clocks. On the CPU the same
sites read the tracer's clock (the work is synchronous there).

``enter_range`` / ``exit_range`` open the profiler range
``repro.<span>`` (a ``record_function`` range) beside a host span, so a
profiler's trace names the program's own waits. The spans they mark run
on the serving threads, and a ``torch.profiler`` records another
thread's ranges only when it profiles every thread
(``_ExperimentalConfig(profile_all_threads=True)``); a thread of its own
reads ``torch.autograd._profiler_enabled()`` False even then, so the
ranges open whenever the tracer is on, at about half a microsecond each
(``_RecordFunctionFast``).
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.obs.export import SEGMENT_CAT


def capturing() -> bool:
    """True while the current CUDA stream captures a graph, when no
    timing event may be recorded; False without CUDA."""
    try:
        return bool(torch.cuda.is_current_stream_capturing())
    except (AssertionError, RuntimeError):
        return False


def enter_range(name: str):
    """The profiler range ``repro.<name>``, entered (callers open it only
    while their tracer is on)."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    rng = fast("repro." + name) if fast is not None \
        else torch.profiler.record_function("repro." + name)
    rng.__enter__()
    return rng


def exit_range(rng) -> None:
    if rng is None:
        return
    try:
        rng.__exit__(None, None, None)
    except RuntimeError:
        # a range entered while no profiler recorded and closed after one
        # started has no guard to close: it is simply not recorded
        pass


class DeviceClock:
    """A CUDA event whose time on the host clock ``clock`` is known.

    The anchor: synchronize the device, read the clock, record an event
    on the idle stream and wait for it, read the clock again; the
    event's host time is the mean of the two readings (``spread_s``
    apart). ``host_ts(ev)`` is then ``t + anchor.elapsed_time(ev)``."""

    def __init__(self, clock, device):
        self.clock = clock
        self.device = torch.device(device)
        self.event, self.t, self.spread_s = self._anchor()

    def _anchor(self) -> tuple:
        torch.cuda.synchronize(self.device)
        ev = torch.cuda.Event(enable_timing=True)
        t0 = self.clock()
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()
        t1 = self.clock()
        return ev, (t0 + t1) / 2, t1 - t0

    def host_ts(self, ev) -> float:
        return self.t + self.event.elapsed_time(ev) / 1e3

    def drift_s(self) -> tuple:
        """A second anchor against the first: (the host clock's advance
        less the device clock's, seconds between the anchors)."""
        ev, t, _ = self._anchor()
        host = t - self.t
        return host - self.event.elapsed_time(ev) / 1e3, host


def _stream(device):
    dev = torch.device(device)
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def _point(stream, clock):
    """A point on ``stream``: a recorded timing event, or without a
    stream (the CPU) a reading of ``clock``."""
    if stream is None:
        return clock()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def timed(clock, device, fn) -> tuple:
    """``fn()`` between two points of ``device``'s current stream:
    (its result, (start, end))."""
    stream = _stream(device)
    p0 = _point(stream, clock)
    y = fn()
    return y, (p0, _point(stream, clock))


class DeviceChain:
    """The boundary points of one dispatch's work on its stream: CUDA
    events on the card, tracer-clock readings on the CPU. ``mark(name)``
    closes the segment ``name``, which began at the previous point;
    ``layer`` labels the layer the next marks belong to."""

    _ids = itertools.count(1)

    def __init__(self, clock, device):
        self.id = next(DeviceChain._ids)
        self.clock = clock
        self.stream = _stream(device)
        self.t_enqueue = clock()
        self.layer = -1
        self.marks = [(None, -1, self.point())]
        self.staged: list = []      # prepare_x's (start, end) pairs

    def point(self):
        return _point(self.stream, self.clock)

    def mark(self, name: str) -> None:
        self.marks.append((name, self.layer, self.point()))

    def emit(self, tracer, *, parent: int = -1, live: int = 0,
             padded: int = 0) -> None:
        """Write the segments into ``tracer``'s ring (after the device
        ran them) and drop the events. Args: ``chain`` (this dispatch),
        ``live``/``padded`` members, ``enqueued`` (the host time the
        chain began), ``layer`` where a segment has one, ``prepared`` on
        ``prepare_x``'s pairs."""
        marks, staged = self.marks, self.staged
        self.marks, self.staged = [], []
        if not tracer.enabled or not marks:
            return
        if self.stream is None:
            def host(p):
                return p
        else:
            dc = getattr(tracer, "device_clock", None)
            if dc is None:
                return
            host = dc.host_ts
        # one args dict for each kind of segment, shared by its spans
        # (the ring and the exporter only read them)
        base = {"chain": self.id, "live": live, "padded": padded,
                "enqueued": self.t_enqueue}
        if staged:
            pre = dict(base, prepared=True)
            for p0, p1 in staged:
                tracer.span_at("stage", SEGMENT_CAT, host(p0), host(p1),
                               parent=parent, args=pre)
        by_layer = {-1: base}
        t_prev = host(marks[0][2])
        for name, layer, p in marks[1:]:
            t = host(p)
            args = by_layer.get(layer)
            if args is None:
                args = by_layer[layer] = dict(base, layer=layer)
            tracer.span_at(name, SEGMENT_CAT, t_prev, t, parent=parent,
                           args=args)
            t_prev = t
