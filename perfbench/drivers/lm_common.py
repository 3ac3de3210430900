"""What the LM cells share: the program's config object built from the
configuration file, the weights, and the check's widest logit gap."""
from __future__ import annotations

import torch

from perfbench.lib.weights import make_params
from perfbench.reference import dense


def sizes(cfg: dict) -> dict:
    return dict(d=cfg["hidden_size"], h=cfg["num_attention_heads"],
                kv=cfg["num_key_value_heads"], hd=cfg["head_dim"],
                ff=cfg["intermediate_size"], layers=cfg["num_hidden_layers"],
                vocab=cfg["vocab_size"])


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a dense GQA + gated-MLP model."""
    from repro_torch.models.config import (FFN_MLP, MIXER_GLOBAL_ATTN,
                                           LayerSpec, ModelConfig)
    return ModelConfig(
        name=cfg["name"], family="dense", d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MLP),),
        n_units=cfg["num_hidden_layers"], tie_embeddings=True,
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        dtype=cfg["dtype"])


def params(cfg: dict, seed: int, device) -> dict:
    return make_params(sizes(cfg), seed ^ 0x6A5, getattr(torch, cfg["dtype"]),
                       device)


def ref_meta(cfg: dict) -> dict:
    return dict(eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
                d=cfg["hidden_size"])


def logit_err(p: dict, cfg: dict, tokens, at, got, mode: str) -> float:
    """The largest |program - reference| logit over the positions ``at``
    of the sequence ``tokens`` (1, S), each position over the reference's
    largest |logit| there; ``got`` (len(at), V) the program's logits. With
    ``mode`` other than "fp32" the reference computed in that precision
    stands in the program's place (the control)."""
    m = ref_meta(cfg)
    ref = dense.lm_logits(p, tokens, at, m)[0]
    if mode != "fp32":
        got = dense.lm_logits(p, tokens, at, m, mode)[0]
    err = (got.to(ref.device, torch.float32) - ref).abs().amax(-1)
    return float((err / ref.abs().amax(-1).clamp_min(1e-30)).max())
