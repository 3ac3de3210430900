"""Operation and byte counts against hand counts at small shapes, and the
model counts against torch's FLOP counter on the plain reference."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import roofline as rl  # noqa: E402
from perfbench.lib.weights import make_params  # noqa: E402
from perfbench.reference import dense  # noqa: E402


def test_attention_hand_counts():
    # causal, b 1, h 2, s = t 3, d 4: 6 live pairs a head, 4 d flops each
    assert rl.attention(1, 2, 1, 3, 3, 4, True, 2) == (
        4 * 4 * 2 * 6, 2 * (2 * 1 * 2 * 3 * 4 + 2 * 1 * 1 * 3 * 4))
    # bidirectional: s * t pairs
    assert rl.attention(2, 1, 1, 2, 5, 8, False, 4)[0] == 4 * 8 * 2 * 10


def test_sgld_and_select_hand_counts():
    f, b = rl.sgld_grad_call(2, 3, 4, 5)
    assert f == 4 * 2 * 3 * 4 * 5 + 7 * 2 * 3 * 5
    assert b == 2 * 3 * (4 * 5 + 16 + 8 + 4) + 4 * 4 * 5 + 5 * 4 + 4 * 2 \
        + 8 * 2 * 5
    assert rl.select(3, 4, 5) == (6 * 3 * 4 * 5,
                                  4 * (15 + 20 + 10 + 6) + 20)


def test_bound_takes_the_larger_side():
    assert rl.bound_s(10.0, 1.0, 10.0, 100.0) == 1.0
    assert rl.bound_s(1.0, 500.0, 10.0, 100.0) == 5.0


def test_encoder_flops_at_the_production_sizes():
    # 14.8 GFLOP a 128-token query through the d-768, 6-layer encoder
    f = rl.encoder_query_flops(128, 768, 12, 64, 3072, 6)
    assert f == (8 * 768 ** 2 + 6 * 768 * 3072 + 4 * 128 * 768) * 128 * 6
    assert 14.7e9 < f < 14.9e9


SIZES = dict(d=32, h=4, kv=2, hd=8, ff=48, layers=2, vocab=64)


def _counted(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("length", [7, 16, 33])
def test_lm_prompt_flops_against_the_counter(length):
    p = make_params(SIZES, 3, torch.float32, torch.device("cpu"))
    m = dict(eps=1e-6, rope_theta=1e4, d=SIZES["d"])
    tok = torch.randint(0, SIZES["vocab"], (1, length))
    counted = _counted(lambda: dense.lm_logits(p, tok, [length - 1], m))
    # the plain reference computes every (query, key) pair, the causal
    # count half of them plus the diagonal
    s = SIZES
    full = s["layers"] * 4 * s["h"] * s["hd"] * length * length
    causal = s["layers"] * 4 * s["h"] * s["hd"] * length * (length + 1) / 2
    want = rl.lm_prompt_flops(length, s["d"], s["h"], s["kv"], s["hd"],
                              s["ff"], s["layers"], s["vocab"])
    assert counted - full == pytest.approx(want - causal)


def test_decode_step_counts():
    s = SIZES
    f, b = rl.lm_decode_step(3, 9, s["d"], s["h"], s["kv"], s["hd"], s["ff"],
                             s["layers"], s["vocab"], 2)
    per_tok = s["layers"] * (rl.layer_matmul_flops(
        s["d"], s["h"], s["kv"], s["hd"], s["ff"]) + 4 * s["h"] * s["hd"] * 10)
    assert f == 3 * (per_tok + 2 * s["d"] * s["vocab"])
    weights = 2 * rl.lm_weight_elems(s["d"], s["h"], s["kv"], s["hd"],
                                     s["ff"], s["layers"], s["vocab"])
    cache = s["layers"] * 2 * 3 * s["kv"] * s["hd"] * 2
    assert b == weights + cache * 10 + cache + 4 * 3 * s["vocab"] + 8 * 3


def test_weight_elems_equal_the_tree():
    p = make_params(SIZES, 1, torch.float32, torch.device("cpu"))
    n = sum(t.numel() for t in _leaves(p))
    s = SIZES
    assert n == rl.lm_weight_elems(s["d"], s["h"], s["kv"], s["hd"], s["ff"],
                                   s["layers"], s["vocab"])


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    return [t]
