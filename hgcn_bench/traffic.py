"""The one traffic generator: every mix is a data file it reads.

A mix (``traffic/<name>.json``) gives

  ``loop``           "closed": ``outstanding`` requests in flight, each
                     replaced when its future resolves; "open": Poisson
                     arrivals at ``rate_per_s``, due on a fixed schedule
  ``deadline_ms``    each request's deadline, passed to ``submit``
  ``target_batch``, ``max_inflight``   the queue's settings
  ``snapshots``      feature snapshots in the pool, kept on the card;
                     each request draws one
  ``feature_density`` Bernoulli probability of a feature being 1
  ``warmup_requests`` (closed) / ``warmup_s`` (open)  set-up traffic
  ``sample``         outputs kept for the comparison with the reference

Every seed gets the same work: the same number of arrivals in the
window, with the same gaps rotated (the gaps are drawn from the mix's
``schedule_seed``, the rotation from the run's seed), and snapshot
choices from the run's seed.
"""
from __future__ import annotations

import numpy as np

LOOPS = ("closed", "open")


def check(traffic: dict) -> None:
    """ValueError for a mix the generator cannot run."""
    loop = traffic.get("loop")
    if loop not in LOOPS:
        raise ValueError(f"traffic loop {loop!r}: one of {LOOPS}")
    need = {"closed": ("outstanding", "warmup_requests"),
            "open": ("rate_per_s", "warmup_s", "schedule_seed")}[loop]
    for key in need + ("deadline_ms", "target_batch", "max_inflight",
                       "snapshots", "feature_density", "sample"):
        if key not in traffic:
            raise ValueError(f"{loop} traffic needs {key!r}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of choices a run makes from its seed
    (1: snapshots, 2: arrival order, 3: the compared sample, 4: the
    open loop's gaps, from the mix's ``schedule_seed``)."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def gaps(traffic: dict, seconds: float) -> np.ndarray:
    """Open loop: the exponential gaps (s) at ``rate_per_s`` drawn from
    the mix's ``schedule_seed``, as many as fit in ``seconds``. One
    sequence for every length: a shorter window's gaps are the first of
    a longer one's."""
    rate = float(traffic["rate_per_s"])
    base = rng(int(traffic["schedule_seed"]), 4)
    out = []
    total = 0.0
    while True:
        g = float(base.exponential(1.0 / rate))
        if total + g > seconds:
            break
        out.append(g)
        total += g
    return np.asarray(out)


def arrivals(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    """Open loop: due offsets (s) of the arrivals in ``[0, seconds]``.

    The mix's ``gaps`` rotated by an offset drawn from ``seed``: every
    seed gets the same gaps, so the same count in the window, and the
    same bursts, shifted in time. (A shuffle by the seed, tried first,
    moved the median latency by up to 5 % from seed to seed against 1 %
    between two runs of one seed: the order of the gaps changes how
    batches form.)"""
    g = gaps(traffic, seconds)
    g = np.roll(g, -int(rng(seed, 2).integers(0, max(len(g), 1))))
    return np.cumsum(g)


def feature_pool(torch, gen, traffic: dict, n: int, f_in: int, device):
    """The mix's feature pool: ``snapshots`` matrices [n, f_in] of
    float32 Bernoulli(``feature_density``), drawn on the device from the
    generator ``gen``, one snapshot a call."""
    p = float(traffic["feature_density"])
    k = int(traffic["snapshots"])
    pool = torch.empty((k, n, f_in), dtype=torch.float32, device=device)
    for s in range(k):
        torch.lt(torch.rand((n, f_in), generator=gen, device=device), p,
                 out=pool[s])
    return pool


class Reservoir:
    """Keeps ``k`` items of a stream, each offered item equally likely to
    stay (Algorithm R), drawn from the seed; the last item offered is
    always kept besides. What the comparison with the reference takes
    from the window's outputs, holding at most ``k + 1`` at a time."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = rng(seed, 3)
        self.kept: list = []
        self.last = None
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1
        self.last = item

    def items(self) -> list:
        out = list(self.kept)
        if self.last is not None and not any(x is self.last for x in out):
            out.append(self.last)
        return out
