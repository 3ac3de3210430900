"""Event-time streaming serving: arrival processes, padding buckets, batch
forming (counterpart of ``repro/serving/stream.py``).

Production routing traffic is a stream, not a synchronized tick: requests
arrive one at a time (Poisson at steady state, bursty under fan-out,
diurnally modulated over a day), and the serving layer decides when to cut
a batch. This module is the host-side half of streaming serving:

* **arrival generators** simulate the three processes (plus a CLI spec
  parser, ``poisson:800`` / ``bursty:800,16`` / ``diurnal:800,0.5,60``)
  as sorted event-time arrays, the reference's numbers from the same seed;
* **batch forming** accumulates arrivals into a batch until the largest
  bucket fills or the oldest waiting request hits the ``max_wait``
  deadline;
* **padding buckets** round each formed batch up to a small ladder of
  power-of-two sizes, so ``RouterService(buckets=...)`` captures exactly
  one CUDA graph per bucket and program, and any batch size reuses them.
  Padded rows ride a boolean mask end to end: they never enter the pending
  ring or the posterior.

Everything here is host-side numpy over event times, except ``pad_rows``,
which also pads a tensor on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_MAX_WAIT = 0.01          # seconds a request may wait for batchmates


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One simulated arrival process.

    ``rate`` is the mean arrival rate (requests/second). ``burst``
    (bursty) is the mean burst size: bursts arrive as a Poisson process of
    rate ``rate / burst`` with Geometric(1/burst) requests each.
    ``depth``/``period`` (diurnal) modulate the rate as rate * (1 + depth *
    sin(2 pi t / period)), by thinning."""
    kind: str                    # poisson | bursty | diurnal
    rate: float
    burst: float = 16.0
    depth: float = 0.5
    period: float = 60.0

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty", "diurnal"):
            raise ValueError(
                f"unknown arrival kind {self.kind!r}: expected poisson, "
                f"bursty or diurnal")
        if not self.rate > 0:
            raise ValueError(f"arrival rate must be positive, got "
                             f"{self.rate}")
        if self.kind == "bursty" and not self.burst >= 1:
            raise ValueError(f"mean burst size must be >= 1, got "
                             f"{self.burst}")
        if self.kind == "diurnal" and not 0 <= self.depth < 1:
            raise ValueError(f"diurnal depth must be in [0, 1), got "
                             f"{self.depth}")


def parse_arrival(spec: str) -> ArrivalSpec:
    """CLI arrival spec: ``poisson:RATE``, ``bursty:RATE[,BURST]``,
    ``diurnal:RATE[,DEPTH[,PERIOD]]``."""
    kind, _, body = spec.partition(":")
    try:
        vals = [float(v) for v in body.split(",")] if body else []
    except ValueError:
        raise ValueError(
            f"arrival spec {spec!r}: parameters after ':' must be "
            f"comma-separated numbers") from None
    if not vals:
        raise ValueError(
            f"arrival spec {spec!r} needs a rate — e.g. 'poisson:800', "
            f"'bursty:800,16', 'diurnal:800,0.5,60'")
    if kind == "poisson" and len(vals) == 1:
        return ArrivalSpec("poisson", vals[0])
    if kind == "bursty" and len(vals) <= 2:
        return ArrivalSpec("bursty", vals[0], burst=(vals + [16.0])[1])
    if kind == "diurnal" and len(vals) <= 3:
        pad = vals + [0.5, 60.0][len(vals) - 1:]
        return ArrivalSpec("diurnal", pad[0], depth=pad[1], period=pad[2])
    raise ValueError(
        f"arrival spec {spec!r}: expected 'poisson:RATE', "
        f"'bursty:RATE[,BURST]' or 'diurnal:RATE[,DEPTH[,PERIOD]]'")


def arrival_times(spec: ArrivalSpec, n: int, seed: int = 0) -> np.ndarray:
    """(n,) sorted float64 arrival times starting near 0."""
    rng = np.random.default_rng(seed)
    if spec.kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / spec.rate, size=n))
    if spec.kind == "bursty":
        # bursts at rate/burst, Geometric(1/burst) requests per burst
        n_bursts = max(n // max(round(spec.burst), 1) + 1, 1) * 2 + 8
        epochs = np.cumsum(rng.exponential(spec.burst / spec.rate,
                                           size=n_bursts))
        sizes = rng.geometric(1.0 / spec.burst, size=n_bursts)
        times = np.repeat(epochs, sizes)
        while times.shape[0] < n:     # geometric tail undershot: extend
            extra = np.cumsum(rng.exponential(spec.burst / spec.rate,
                                              size=n_bursts)) + times[-1]
            sizes = rng.geometric(1.0 / spec.burst, size=n_bursts)
            times = np.concatenate([times, np.repeat(extra, sizes)])
        return times[:n]
    # diurnal: inhomogeneous Poisson by thinning at the peak rate
    peak = spec.rate * (1.0 + spec.depth)
    chunks, have, t = [], 0, 0.0
    while have < n:
        gaps = rng.exponential(1.0 / peak, size=max(n, 256))
        cand = t + np.cumsum(gaps)
        t = cand[-1]
        accept = rng.uniform(size=cand.shape[0]) * peak <= spec.rate * (
            1.0 + spec.depth * np.sin(2.0 * np.pi * cand / spec.period))
        kept = cand[accept]
        chunks.append(kept)
        have += kept.shape[0]
    return np.concatenate(chunks)[:n]


# ---------------------------------------------------------------------------
# Padding buckets
# ---------------------------------------------------------------------------

def validate_buckets(buckets, n_shards: int = 1) -> tuple:
    """Normalize and check a bucket ladder: sorted, unique, powers of two,
    each divisible over the batch shards."""
    out = tuple(sorted({round(b) for b in buckets}))
    if not out:
        raise ValueError("buckets: need at least one padding bucket size")
    for b in out:
        if b < 1 or b & (b - 1):
            raise ValueError(
                f"bucket sizes must be powers of two (the serving surface "
                f"captures one program per bucket; a pow2 ladder bounds "
                f"padding waste at 2x), got {b}")
        if b % n_shards:
            raise ValueError(
                f"bucket {b} does not divide over the mesh's {n_shards} "
                f"batch shards")
    return out


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket >= n (the program the formed batch runs through)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"batch of {n} exceeds the largest padding bucket {buckets[-1]} — "
        f"form smaller batches or extend the ladder")


class FormedBatch(NamedTuple):
    """One dynamic batch: rows ``[start, start + n)`` of the stream, padded
    to ``bucket`` rows. ``t_form`` is the event time the batch was cut;
    row i waited ``t_form - times[start + i]``."""
    start: int
    n: int
    bucket: int
    t_form: float


def form_batches(times: np.ndarray, buckets, max_wait: float
                 ) -> list[FormedBatch]:
    """Greedy event-time batch forming over a sorted arrival-time array.

    A batch is cut as soon as the largest bucket fills, or when the oldest
    waiting arrival has waited ``max_wait``, whichever comes first; the
    deadline cut takes every arrival that landed by the deadline (at least
    one)."""
    buckets = validate_buckets(buckets)
    if not max_wait >= 0:
        raise ValueError(f"max_wait must be >= 0 seconds, got {max_wait}")
    b_max = buckets[-1]
    total = times.shape[0]
    out: list[FormedBatch] = []
    i = 0
    while i < total:
        deadline = times[i] + max_wait
        hi = min(i + b_max, total)
        j = i + np.searchsorted(times[i:hi], deadline, side="right")
        j = max(j, i + 1)            # the deadline row itself always ships
        n = j - i
        t_form = times[j - 1] if n == b_max else deadline
        out.append(FormedBatch(start=i, n=n, bucket=bucket_for(n, buckets),
                               t_form=t_form))
        i = j
    return out


def pad_rows(arr, bucket: int):
    """Pad axis 0 with zeros up to ``bucket`` rows (numpy array or tensor,
    on its own device; returned as is when already full)."""
    pad = bucket - arr.shape[0]
    if pad < 0:
        raise ValueError(f"batch of {arr.shape[0]} rows does not fit "
                         f"bucket {bucket}")
    if pad == 0:
        return arr
    if isinstance(arr, np.ndarray):
        return np.concatenate(
            [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
