"""The traffic generators: deterministic per seed, with the lengths and
rates their files state, and the frozen copies equal to the port's."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.drivers import lm_prefill  # noqa: E402
from perfbench.lib import arrivals  # noqa: E402


def _traffic(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_arrivals_equal_the_ports(kind):
    from repro_torch.serving import stream
    spec = stream.ArrivalSpec(kind, 800.0, burst=24.0)
    want = stream.arrival_times(spec, 5000, seed=2**31 + 9)
    got = arrivals.arrival_times(kind, 800.0, 5000, 2**31 + 9, burst=24.0)
    np.testing.assert_array_equal(got, want)


def test_form_batches_equal_the_ports():
    from repro_torch.serving import stream
    t = arrivals.arrival_times("poisson", 3000.0, 20000, 7)
    want = stream.form_batches(t, (256, 512, 1024, 2048, 4096), 0.02)
    got = arrivals.form_batches(t, (256, 512, 1024, 2048, 4096), 0.02)
    assert [tuple(b) for b in want] == got


def test_poisson_rate_of_the_text_cell():
    tr = _traffic("text-poisson")
    rate = tr["arrival"]["rate"]
    t = arrivals.arrival_times("poisson", rate, 200000, 3)
    assert abs(len(t) / t[-1] - rate) / rate < 0.01
    again = arrivals.arrival_times("poisson", rate, 200000, 3)
    np.testing.assert_array_equal(t, again)


def test_deadline_batcher_cuts_by_the_event_time_rule():
    """On a clock that jumps to each cut, the wall-clock batcher forms the
    batches ``form_batches`` forms."""
    t = arrivals.arrival_times("poisson", 3000.0, 5000, 11)
    want = arrivals.form_batches(t, (256, 4096), 0.02)
    b = arrivals.DeadlineBatcher(t, 4096, 0.02)
    got, now = [], 0.0
    while len(got) < len(want):
        start, v = b.next_cut(now)
        if start is None:
            now = v
            continue
        got.append((start, v))
    assert got == [(s, n) for s, n, _, _ in want]


def test_query_lengths_of_the_text_cell():
    spec = _traffic("text-poisson")["query_len"]
    a = arrivals.query_lengths(np.random.default_rng(5), 100000, spec)
    b = arrivals.query_lengths(np.random.default_rng(5), 100000, spec)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= spec["min"] and a.max() <= spec["max"]
    assert abs(np.median(a) - spec["median"]) <= 1


def test_prefill_backlog():
    tr = _traffic("prefill-mix")
    tr["backlog_slots"] = 16384 * 200
    batches = lm_prefill._backlog(tr, 2**31 + 3)
    again = lm_prefill._backlog(tr, 2**31 + 3)
    assert len(batches) == len(again) and all(
        (a[0] == b[0]).all() and a[1] == b[1] for a, b in zip(batches, again))
    lens = np.concatenate([lens for lens, _ in batches])
    assert lens.min() >= 256 and lens.max() <= 4096
    for lens_b, b in batches:
        assert b & (b - 1) == 0 and len(lens_b) * b == tr["slots_per_batch"]
        assert (lens_b <= b).all()
        assert b == 256 or (lens_b > b // 2).all()
    # log-uniform: the median near the geometric mean of the range
    assert abs(np.log(np.median(lens)) - np.log(1024)) < 0.1
    slots = sum(len(lens_b) * b for lens_b, b in batches)
    assert abs(lens.sum() / slots - 1 / (2 * np.log(2))) < 0.03
