"""Sharding rules of the candidate LMs (counterpart of
``repro/sharding/rules.py``): which dimension of every parameter,
optimizer moment, input and cache tensor splits over which mesh axis.

Policy (mesh axes ("data", "model") or ("pod", "data", "model")):

* tensor parallel over ``model``: attention heads (when both head counts
  divide, else head_dim), MLP d_ff, experts (when divisible, else the
  expert d_ff), RG-LRU width, the SSD block's out_proj rows, vocab (when
  divisible, else d_model).
* batch over ("pod", "data") for activations and inputs.
* ``fsdp`` archs (arctic, mistral-large, llava-34b) also split the
  non-TP parameter dim over ``data`` (ZeRO-3 style); the rank program of
  ``launch/dryrun.py`` gathers each unit's shards before use.
* optimizer state is split exactly like its parameter.
* KV caches: batch over the batch axes, head_dim over model (works for
  every kv-head count); recurrent and SSM states: width over model.

Specs are data: ``routing_rules.P``, one entry per dimension (a mesh axis
name, a tuple of names, or None). The functions read the mesh's axis
names and sizes only, from a ``DeviceMesh`` (``mesh_dim_names``) or from
any object with ``axis_names`` and a ``shape`` mapping names to sizes, so
spec trees are built without a world. The reference's ``to_shardings``
(``NamedSharding`` trees for ``jax.jit``) has no counterpart: torch has no
partitioner to hand them to; ``launch/dryrun.py`` reads the specs through
``routing_rules.local_shape`` instead.
"""
from __future__ import annotations

from repro_torch.models.config import (FFN_NONE, MIXER_CROSS_ATTN,
                                       MIXER_RGLRU, MIXER_SSD, ModelConfig)
from repro_torch.sharding.routing_rules import P


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _div(n: int, k: int) -> bool:
    return n % k == 0


def _msize(mesh, name: str) -> int:
    return mesh_axis_sizes(mesh)[name]


def fsdp_axis(cfg: ModelConfig, mesh):
    """"data" for an ``fsdp`` arch on a mesh with that axis, else None."""
    return "data" if (cfg.fsdp and "data" in axis_names(mesh)) else None


def heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether attention splits heads over ``model`` (both head counts
    divide), else head_dim."""
    m = _msize(mesh, "model")
    return _div(cfg.n_heads, m) and _div(cfg.n_kv_heads, m)


def repeat_kv(cfg: ModelConfig, mesh) -> bool:
    """Whether attention takes the repeat-KV layout: Q/O split on heads,
    the small K/V replicated."""
    return cfg.gqa_impl == "repeat" and _div(cfg.n_heads,
                                             _msize(mesh, "model"))


def attn_specs(cfg: ModelConfig, mesh, fsdp_ax) -> dict:
    # wq: (d, H, hd)   wk/wv: (d, KV, hd)   wo: (H, hd, d)
    if repeat_kv(cfg, mesh):
        sp = {"wq": P(fsdp_ax, "model", None), "wk": P(fsdp_ax, None, None),
              "wv": P(fsdp_ax, None, None), "wo": P("model", None, fsdp_ax)}
        if cfg.qkv_bias:
            sp.update({"bq": P("model", None), "bk": P(None, None),
                       "bv": P(None, None)})
        return sp
    heads_ok = heads_split(cfg, mesh)
    if heads_ok:
        sp = {"wq": P(fsdp_ax, "model", None), "wk": P(fsdp_ax, "model", None),
              "wv": P(fsdp_ax, "model", None), "wo": P("model", None, fsdp_ax)}
    else:
        sp = {"wq": P(fsdp_ax, None, "model"), "wk": P(fsdp_ax, None, "model"),
              "wv": P(fsdp_ax, None, "model"), "wo": P(None, "model", fsdp_ax)}
    if cfg.qkv_bias:
        last = "model" if not heads_ok else None
        first = "model" if heads_ok else None
        sp.update({"bq": P(first, last), "bk": P(first, last),
                   "bv": P(first, last)})
    return sp


def mlp_specs(fsdp_ax) -> dict:
    return {"w1": P(fsdp_ax, "model"), "w3": P(fsdp_ax, "model"),
            "w2": P("model", fsdp_ax)}


def experts_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the MoE FFN is expert-parallel over ``model``, else its
    expert d_ff is split."""
    return _div(cfg.n_experts, _msize(mesh, "model"))


def moe_specs(cfg: ModelConfig, mesh, fsdp_ax) -> dict:
    if experts_split(cfg, mesh):
        sp = {"router": P(None, None),
              "w1": P("model", fsdp_ax, None), "w3": P("model", fsdp_ax, None),
              "w2": P("model", None, fsdp_ax)}
    else:
        sp = {"router": P(None, None),
              "w1": P(None, fsdp_ax, "model"), "w3": P(None, fsdp_ax, "model"),
              "w2": P(None, "model", fsdp_ax)}
    if cfg.dense_residual_ff:
        sp["dense"] = mlp_specs(fsdp_ax)
    return sp


def rglru_specs(fsdp_ax) -> dict:
    return {"wy": P(fsdp_ax, "model"), "wx": P(fsdp_ax, "model"),
            "wo": P("model", fsdp_ax), "conv": P(None, "model"),
            "wa": P(None, "model"), "ba": P("model"),
            "wi": P(None, "model"), "bi": P("model"), "lambda": P("model")}


def ssd_specs(fsdp_ax) -> dict:
    # in_proj's output mixes [z, x, B, C, dt]: replicated on that axis
    return {"in_proj": P(fsdp_ax, None), "conv": P(None, None),
            "dt_bias": P(None), "a_log": P(None), "d_skip": P(None),
            "norm_z": P(None), "out_proj": P("model", fsdp_ax)}


def block_specs(cfg: ModelConfig, mesh, spec, fsdp_ax) -> dict:
    out: dict = {"norm1": P(None)}
    if spec.mixer == MIXER_RGLRU:
        out["mixer"] = rglru_specs(fsdp_ax)
    elif spec.mixer == MIXER_SSD:
        out["mixer"] = ssd_specs(fsdp_ax)
    else:
        out["mixer"] = attn_specs(cfg, mesh, fsdp_ax)
        if spec.mixer == MIXER_CROSS_ATTN:
            out["norm_x"] = P(None)
            out["xattn"] = attn_specs(cfg, mesh, fsdp_ax)
    if spec.ffn != FFN_NONE:
        out["norm2"] = P(None)
        if spec.ffn == "mlp":
            out["ffn"] = mlp_specs(fsdp_ax)
        else:
            out["ffn"] = moe_specs(cfg, mesh, fsdp_ax)
    return out


def stack_spec(tree):
    """Every spec of ``tree`` with a replicated leading axis (the stacked
    units' ``n_units`` axis)."""
    if isinstance(tree, dict):
        return {k: stack_spec(v) for k, v in tree.items()}
    return P(None, *tree)


def _unit_specs(cfg, mesh, specs, fsdp_ax, stacked: bool):
    unit = {str(i): block_specs(cfg, mesh, s, fsdp_ax)
            for i, s in enumerate(specs)}
    return stack_spec(unit) if stacked else unit


def embed_spec(cfg: ModelConfig, mesh, fsdp_ax) -> P:
    if _div(cfg.vocab_size, _msize(mesh, "model")):
        return P("model", fsdp_ax)
    return P(None, "model")


def param_specs(cfg: ModelConfig, mesh) -> dict:
    fsdp_ax = fsdp_axis(cfg, mesh)
    sp: dict = {
        "embed": embed_spec(cfg, mesh, fsdp_ax),
        "units": _unit_specs(cfg, mesh, cfg.pattern, fsdp_ax, stacked=True),
        "final_norm": P(None),
    }
    if cfg.remainder:
        sp["remainder"] = _unit_specs(cfg, mesh, cfg.remainder, fsdp_ax,
                                      stacked=False)
    if not cfg.tie_embeddings:
        sp["lm_head"] = embed_spec(cfg, mesh, fsdp_ax)
    if cfg.frontend == "vision":
        sp["vis_proj"] = P(fsdp_ax, "model")
    if cfg.is_encdec:
        sp["enc_units"] = _unit_specs(cfg, mesh, cfg.enc_pattern, fsdp_ax,
                                      stacked=True)
        sp["enc_norm"] = P(None)
    return sp


def batch_specs(cfg: ModelConfig, mesh, kind: str) -> dict:
    bs = P(batch_axes(mesh), None)
    sp = {"tokens": bs}
    if kind == "train":
        sp["labels"] = bs
    if cfg.frontend == "vision":
        sp["patches"] = P(batch_axes(mesh), None, None)
    if cfg.is_encdec:
        sp["frames"] = P(batch_axes(mesh), None, None)
    return sp


def block_cache_spec_for(cfg: ModelConfig, mesh, spec, bx=None) -> dict:
    """The spec of one block's cache (``blocks.init_block_cache``'s
    layout)."""
    bx = batch_axes(mesh) if bx is None else bx
    if spec.mixer == MIXER_RGLRU:
        return {"rnn": {"h": P(bx, "model"), "conv": P(bx, None, "model")}}
    if spec.mixer == MIXER_SSD:
        return {"ssm": {"h": P(bx, "model", None, None),
                        "conv": P(bx, None, None)}}
    out = {"kv": {"k": P(bx, None, None, "model"),
                  "v": P(bx, None, None, "model"), "slot_pos": P(None)}}
    if spec.mixer == MIXER_CROSS_ATTN:
        out["xk"] = P(bx, None, None, "model")
        out["xv"] = P(bx, None, None, "model")
    return out


def cache_specs(cfg: ModelConfig, mesh, stacked: bool = True,
                bx: tuple | None = None) -> dict:
    """The specs of ``lm.init_cache``'s tree."""
    bx = batch_axes(mesh) if bx is None else bx
    unit = {str(i): block_cache_spec_for(cfg, mesh, s, bx)
            for i, s in enumerate(cfg.pattern)}
    out = {"units": stack_spec(unit) if stacked else unit}
    if cfg.remainder:
        out["remainder"] = {str(i): block_cache_spec_for(cfg, mesh, s, bx)
                            for i, s in enumerate(cfg.remainder)}
    return out


def opt_state_specs(param_sp: dict) -> dict:
    """AdamW state = {mu, nu, step}; mu and nu split like the parameter."""
    return {"mu": param_sp, "nu": param_sp, "step": P()}
