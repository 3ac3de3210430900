"""Traffic generation, frozen here so that program changes cannot move it.

``arrival_times`` and ``form_batches`` are copies of the port's
``serving/stream.py`` functions of the same names (their numbers from the
same seed). ``DeadlineBatcher`` cuts batches on the wall clock by the same
rule as ``form_batches`` cuts them in event time: when the largest bucket
fills, or when the oldest waiting request has waited ``max_wait``.
"""
from __future__ import annotations

import numpy as np


def arrival_times(kind: str, rate: float, n: int, seed: int,
                  burst: float = 16.0) -> np.ndarray:
    """(n,) sorted float64 arrival times starting near 0: ``poisson`` at
    ``rate``, or ``bursty``: bursts at rate / burst with Geometric(1 /
    burst) requests each."""
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    if kind != "bursty":
        raise ValueError(f"unknown arrival kind {kind!r}")
    n_bursts = max(n // max(round(burst), 1) + 1, 1) * 2 + 8
    epochs = np.cumsum(rng.exponential(burst / rate, size=n_bursts))
    sizes = rng.geometric(1.0 / burst, size=n_bursts)
    times = np.repeat(epochs, sizes)
    while times.shape[0] < n:
        extra = np.cumsum(rng.exponential(burst / rate,
                                          size=n_bursts)) + times[-1]
        sizes = rng.geometric(1.0 / burst, size=n_bursts)
        times = np.concatenate([times, np.repeat(extra, sizes)])
    return times[:n]


def shuffled(values: np.ndarray, seed: int) -> np.ndarray:
    """``values`` in an order drawn from ``seed``: every seed gets the same
    set of gaps or sizes, so runs differ in order and not in work."""
    return values[np.random.default_rng([seed, 0x5F]).permutation(
        values.shape[0])]


def shuffled_arrivals(kind: str, rate: float, n: int, base_seed: int,
                      seed: int, burst: float = 16.0) -> np.ndarray:
    """The arrival times of ``arrival_times(..., base_seed)`` with their
    groups (requests arriving together: a burst, or one Poisson arrival)
    in an order drawn from ``seed``, each group keeping its gap before it
    and its size."""
    t = arrival_times(kind, rate, n, base_seed, burst)
    epochs, sizes = np.unique(t, return_counts=True)
    order = shuffled(np.arange(epochs.shape[0]), seed)
    gaps = np.diff(epochs, prepend=0.0)[order]
    return np.repeat(np.cumsum(gaps), sizes[order])


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


def form_batches(times: np.ndarray, buckets, max_wait: float) -> list:
    """Event-time deadline batching: (start, n, bucket, t_form) per batch."""
    b_max = buckets[-1]
    out, i, total = [], 0, times.shape[0]
    while i < total:
        deadline = times[i] + max_wait
        hi = min(i + b_max, total)
        j = max(i + int(np.searchsorted(times[i:hi], deadline,
                                        side="right")), i + 1)
        n = j - i
        out.append((i, n, bucket_for(n, buckets),
                    times[j - 1] if n == b_max else deadline))
        i = j
    return out


class DeadlineBatcher:
    """Wall-clock batch forming over due times ``due`` (seconds on the
    caller's clock). ``next_cut(now)`` returns (start, n) of the batch to
    cut at ``now``, or the time to wait until as (None, t)."""

    def __init__(self, due: np.ndarray, b_max: int, max_wait: float):
        self.due, self.b_max, self.max_wait = due, b_max, max_wait
        self.next = 0

    def next_cut(self, now: float):
        i = self.next
        if i >= self.due.shape[0]:
            return None, float("inf")
        arrived = int(np.searchsorted(self.due, now, side="right")) - i
        if arrived <= 0:
            return None, float(self.due[i])
        if arrived >= self.b_max or now >= self.due[i] + self.max_wait:
            n = min(arrived, self.b_max)
            self.next = i + n
            return i, n
        full = i + self.b_max - 1
        t_full = self.due[full] if full < self.due.shape[0] else np.inf
        return None, float(min(self.due[i] + self.max_wait, t_full))


def query_lengths(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """(n,) int lengths: log-normal (``median``, ``sigma``) or log-uniform
    (``lo``, ``hi``), clipped to [min, max]."""
    if spec["dist"] == "lognormal":
        v = np.exp(np.log(spec["median"]) + spec["sigma"]
                   * rng.standard_normal(n))
    elif spec["dist"] == "loguniform":
        v = np.exp(rng.uniform(np.log(spec["min"]), np.log(spec["max"]), n))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.round(v), spec["min"], spec["max"]).astype(np.int64)
