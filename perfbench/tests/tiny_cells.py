"""Tiny versions of the benchmark's configurations and traffic, for the
CPU tests: the same drivers and checks at sizes a test run holds."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(kind: str, name: str) -> dict:
    return json.loads((ROOT / "perfbench" / kind / f"{name}.json").read_text())


def router(traffic: str) -> tuple[dict, dict]:
    cfg = copy.deepcopy(load("configs", "router-prod"))
    cfg["encoder"].update(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          d_ff=128, max_len=16)
    cfg["policy"].update(dim=64 + 14, horizon=1024, n_chains=2, sgld_steps=3,
                         sgld_minibatch=16)
    cfg["feedback_capacity"] = 256
    tr = copy.deepcopy(load("traffic", traffic))
    tr.update(buckets=[8, 16, 32] if tr["mode"] == "open" else [32],
              history_batches=2)
    if tr["mode"] == "open":
        tr["arrival"]["rate"] = 400
        tr["query_len"].update(median=8, min=2, max=16)
        tr["check"].update(enc_rows=48, acts=1, act_first_batches=2)
    else:
        tr.update(pool_batches=3)
        tr["check"].update(acts=1, act_first_batches=2)
    return cfg, tr


def lm(traffic: str) -> tuple[dict, dict]:
    cfg = copy.deepcopy(load("configs", "granite-3-2b"))
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=256)
    tr = copy.deepcopy(load("traffic", traffic))
    if tr["driver"] == "lm_prefill":
        tr["prompt_len"].update(min=4, max=32)
        tr.update(min_bucket=4, slots_per_batch=64, backlog_slots=64 * 4000)
        tr["check"]["slots"] = 96
    else:
        tr.update(sessions=4, context=16, cache_len=4096, prefill_rows=2,
                  trace_seconds=1)
        tr["check"]["sessions"] = 2
    return cfg, tr


def ctx(cfg: dict, tr: dict, seed: int = 2**31 + 5, seconds: float = 1.0):
    import torch

    from perfbench.lib.ctx import Ctx
    return Ctx(cell="tiny", config=cfg, traffic=tr, limits={}, seed=seed,
               seconds=seconds, trace=False, device=torch.device("cpu"),
               t_process=0.0)


def run(driver: str, cfg: dict, tr: dict, **kw):
    """Set up, run the window and free the program's state; (ctx, state).
    One intra-op thread meanwhile: the test runner's workers share the
    cores, and a window is a fixed time."""
    import importlib

    import torch
    mod = importlib.import_module("perfbench.drivers." + driver)
    c = ctx(cfg, tr, **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        st = mod.setup(c)
        mod.window(c, st)
        mod.release(c, st)
    finally:
        torch.set_num_threads(threads)
    return mod, c, st
