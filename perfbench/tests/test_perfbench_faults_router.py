"""The router cells' check at a size a test run holds, on the CPU: a sound
run is correct under the cells' limits; a run with the timed path broken
underneath (the fold that leaves the ring unchanged, the act that returns
its chains unchanged, half of a batch left out, a pair altered where it is
produced) and the control (the reference in TF32 in the program's place)
are not."""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny_cells as tc  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.reference import dense  # noqa: E402

CELLS = {"text-poisson": "router-prod.text-poisson",
         "embedded-backlog": "router-prod.embedded-backlog"}


def _limits(traffic):
    return json.loads((tc.ROOT / "perfbench" / "workloads"
                       / f"{CELLS[traffic]}.json").read_text())["limits"]


def _checks(traffic, mode="fp32"):
    cfg, tr = tc.router(traffic)
    mod, c, st = tc.run("router_stream", cfg, tr, seconds=1.0)
    with dense.precision():
        return mod.check(c, st, mode)


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_sound_run_is_correct(traffic):
    assert run.judge(_checks(traffic), _limits(traffic))


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_control_is_not_correct(traffic):
    assert not run.judge(_checks(traffic, "tf32"), _limits(traffic))


def _fold_unchanged(monkeypatch):
    from repro_torch.serving import RouterService
    monkeypatch.setattr(RouterService, "feedback_stream",
                        lambda self, tickets, y: None)


def _act_unchanged(monkeypatch):
    from repro_torch.core import policy
    monkeypatch.setattr(policy, "_refresh", lambda draws, inner, *a, **k:
                        inner)


def _pair_altered(monkeypatch):
    from repro_torch.serving import RouterService
    orig = RouterService.route_stream

    def route(self, x, prefs=None, cats=None):
        a1, a2, tk = orig(self, x, prefs, cats)
        return (a1 + 1) % self.a_emb.shape[0], a2, tk
    monkeypatch.setattr(RouterService, "route_stream", route)


def _half_left_out(monkeypatch):
    """The route program is handed the first half of each batch; the
    rest of its rows are left zero."""
    from repro_torch.serving import RouterService
    orig = RouterService.route_stream

    def route(self, x, prefs=None, cats=None):
        x = x.clone()
        x[x.shape[0] // 2:] = 0.0
        return orig(self, x, prefs, cats)
    monkeypatch.setattr(RouterService, "route_stream", route)


def _half_embedded(monkeypatch):
    """The encoder embeds half of each batch; the rest stay zero."""
    from repro_torch.serving import RouterService
    orig = RouterService.embed

    def embed(self, tokens, mask):
        x = orig(self, tokens, mask)
        x[x.shape[0] // 2:] = 0.0
        return x
    monkeypatch.setattr(RouterService, "embed", embed)


FAULTS = [("embedded-backlog", _fold_unchanged),
          ("embedded-backlog", _act_unchanged),
          ("embedded-backlog", _pair_altered),
          ("embedded-backlog", _half_left_out),
          ("text-poisson", _half_embedded),
          ("text-poisson", _pair_altered)]


@pytest.mark.parametrize("traffic,fault", FAULTS,
                         ids=[f"{t}-{f.__name__[1:]}" for t, f in FAULTS])
def test_fault_is_not_correct(traffic, fault, monkeypatch):
    fault(monkeypatch)
    assert not run.judge(_checks(traffic), _limits(traffic))
