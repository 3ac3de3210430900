"""The LM cells' check at a size a test run holds, on the CPU: a sound
run is correct under the cells' limits; a token altered where it is
produced, half of a batch left out and a decode step that leaves the cache
unchanged are not."""
import copy
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny_cells as tc  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.reference import dense  # noqa: E402

CELLS = {"prefill-mix": ("granite-3-2b.prefill-mix", "lm_prefill"),
         "decode-b128": ("granite-3-2b.decode-b128", "lm_decode")}


def _limits(traffic):
    return json.loads((tc.ROOT / "perfbench" / "workloads"
                       / f"{CELLS[traffic][0]}.json").read_text())["limits"]


def _checks(traffic, mode="fp32"):
    cfg, tr = tc.lm(traffic)
    mod, c, st = tc.run(CELLS[traffic][1], cfg, tr, seconds=1.0)
    with dense.precision():
        return mod.check(c, st, mode)


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_sound_run_is_correct(traffic):
    assert run.judge(_checks(traffic), _limits(traffic))


def _token_altered(monkeypatch):
    from repro_torch.models import lm
    pre, dec = lm.prefill, lm.decode_step
    monkeypatch.setattr(lm, "prefill", lambda *a, **k: (
        lambda out: (out[0].roll(1, dims=-1), out[1]))(pre(*a, **k)))
    monkeypatch.setattr(lm, "decode_step", lambda *a, **k: (
        lambda out: (out[0].roll(1, dims=-1), out[1]))(dec(*a, **k)))


def _half_left_out(monkeypatch):
    from repro_torch.models import lm
    pre, dec = lm.prefill, lm.decode_step

    def cut(out):
        logits = out[0].clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, out[1]
    monkeypatch.setattr(lm, "prefill", lambda *a, **k: cut(pre(*a, **k)))
    monkeypatch.setattr(lm, "decode_step", lambda *a, **k: cut(dec(*a, **k)))


def _cache_unchanged(monkeypatch):
    from repro_torch.models import lm
    dec = lm.decode_step

    def step(params, cache, tokens, pos, cfg):
        logits, _ = dec(params, copy.deepcopy(cache), tokens, pos, cfg)
        return logits, cache
    monkeypatch.setattr(lm, "decode_step", step)


FAULTS = [("prefill-mix", _token_altered), ("prefill-mix", _half_left_out),
          ("decode-b128", _token_altered), ("decode-b128", _half_left_out),
          ("decode-b128", _cache_unchanged)]


@pytest.mark.parametrize("traffic,fault", FAULTS,
                         ids=[f"{t}-{f.__name__[1:]}" for t, f in FAULTS])
def test_fault_is_not_correct(traffic, fault, monkeypatch):
    fault(monkeypatch)
    assert not run.judge(_checks(traffic), _limits(traffic))


def test_fp8_control_is_not_correct():
    """The control (the reference in float8 in the program's place) reads
    a logit error far above the sound run's, at a width where a test run
    holds it."""
    cfg, tr = tc.lm("decode-b128")
    cfg.update(hidden_size=256, intermediate_size=512, vocab_size=4096,
               num_attention_heads=4, head_dim=64, num_hidden_layers=8)
    mod, c, st = tc.run("lm_decode", cfg, tr, seconds=1.0)
    with dense.precision():
        sound = mod.check(c, st)["logit_err"]
        control = mod.check(c, st, "fp8")["logit_err"]
    assert control > 5 * sound
    assert not run.judge({"logit_err": control}, _limits("decode-b128"))
