"""Carry weights and state between the JAX package and the port as numpy.

The arm table (``ModelPool``), the query encoder's parameters and the
candidate LMs' parameters are this system's weights (the LMs' decode
caches their state, the encoder's AdamW moments its training state); the
replay ring and the SGLD chains (``FGTSState``), the
mixed ring (``MixedHistory``), the baselines' estimates and the
autopilot's ``ControllerState`` its state. The
reference's arrays come out with ``jax.device_get`` (or ``numpy.asarray``);
these functions build the port's NamedTuples from them on a given device,
and back. Floats are cast to float32 and integers to int32 on the way in,
so numpy's float64 default never reaches the port's arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.autopilot.controller import AutopilotState, ControllerState
from repro_torch.core.baselines import EpsGreedyState, LinUCBState
from repro_torch.core.extensions import MixedHistory, MixedState
from repro_torch.core.fgts import FGTSState
from repro_torch.core.model_pool import ModelPool, PooledState
from repro_torch.device import as_f32, resolve_device


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def pool_from_numpy(a_emb, costs, active, generation, device=None) -> ModelPool:
    dev = resolve_device(device)
    return ModelPool(
        a_emb=as_f32(a_emb, dev), costs=as_f32(costs, dev),
        active=torch.tensor(np.asarray(active, dtype=bool), device=dev),
        generation=_i32(generation, dev))


def fgts_state_from_numpy(x, a1, a2, y, t, theta1, theta2, pref=None,
                          device=None) -> FGTSState:
    """Ring x (H,d), a1/a2/y/pref (H,), count t, chains theta1/theta2
    ((C,d) or (d,))."""
    dev = resolve_device(device)
    return FGTSState(
        x=as_f32(x, dev), a1=_i32(a1, dev), a2=_i32(a2, dev),
        y=as_f32(y, dev), t=_i32(t, dev), theta1=as_f32(theta1, dev),
        theta2=as_f32(theta2, dev),
        pref=None if pref is None else as_f32(pref, dev))


def pooled_state_from_numpy(inner: dict, pool: dict,
                            device=None) -> PooledState:
    """``inner``: the fields of ``fgts_state_from_numpy``; ``pool``: those
    of ``pool_from_numpy``."""
    return PooledState(fgts_state_from_numpy(**inner, device=device),
                       pool_from_numpy(**pool, device=device))


def tuple_from_numpy(cls, fields: dict, device=None):
    """A NamedTuple ``cls`` of the port whose fields are all tensors
    (``ControllerState``, ``MixedHistory``, ``EpsGreedyState``,
    ``LinUCBState``) from a dict of its fields: bools stay bool, integers
    become int32, everything else float32."""
    dev = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.tensor(a, device=dev)
        if np.issubdtype(a.dtype, np.integer):
            return _i32(a, dev)
        return as_f32(a, dev)
    return cls(**{f: tensor(fields[f]) for f in cls._fields})


def autopilot_state_from_numpy(inner: dict, pool: dict, ctrl: dict,
                               device=None) -> AutopilotState:
    """An autopiloted pooled FGTS state: ``inner`` and ``pool`` as for
    ``pooled_state_from_numpy``, ``ctrl`` the ``ControllerState`` fields."""
    return AutopilotState(pooled_state_from_numpy(inner, pool, device),
                          tuple_from_numpy(ControllerState, ctrl, device))


def baseline_state_from_numpy(name: str, inner, pool: dict | None = None,
                              device=None):
    """A baseline's state from the reference's inner state, by policy name:
    {"theta"} (eps_greedy), {"A", "b"} (linucb_duel) or the 0-d array of a
    stateless one (uniform, best_fixed); pooled when ``pool`` (the
    ``pool_from_numpy`` fields) is given."""
    if name == "eps_greedy":
        s = tuple_from_numpy(EpsGreedyState, inner, device)
    elif name == "linucb_duel":
        s = tuple_from_numpy(LinUCBState, inner, device)
    else:
        s = as_f32(inner, resolve_device(device))
    return s if pool is None else PooledState(
        s, pool_from_numpy(**pool, device=device))


def mixed_state_from_numpy(h: dict, theta, pool: dict | None = None,
                           device=None):
    """A ``mixed_feedback_policy`` state: ``h`` the ``MixedHistory`` fields,
    ``theta`` the (n_chains, dim) chains; pooled when ``pool`` is given."""
    s = MixedState(tuple_from_numpy(MixedHistory, h, device),
                   as_f32(theta, resolve_device(device)))
    return s if pool is None else PooledState(
        s, pool_from_numpy(**pool, device=device))


def encoder_params_from_numpy(params: dict, device=None) -> dict:
    """The reference's encoder parameters (a nested dict of arrays, as
    ``jax.device_get`` returns them) as the port's: the same nested dict of
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: encoder_params_from_numpy(v, dev) if isinstance(v, dict)
            else as_f32(v, dev) for k, v in params.items()}


def adamw_state_from_numpy(state: dict, device=None) -> dict:
    """The reference's AdamW state (``optim/adamw.py::adamw_init`` /
    ``adamw_update``: {"mu", "nu", "step"}, as ``jax.device_get`` returns
    it) as the port's: the moments as float32 trees, the step a 0-d
    int32 tensor, on ``device``."""
    dev = resolve_device(device)
    return {"mu": encoder_params_from_numpy(state["mu"], dev),
            "nu": encoder_params_from_numpy(state["nu"], dev),
            "step": _i32(state["step"], dev)}


def _leaf(a, device) -> torch.Tensor:
    """One LM leaf: bfloat16 stays bfloat16 (its bits carried over), other
    floats become float32 (float64 too), integers int32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return _i32(a, device)
    return as_f32(a, device)


def lm_params_from_numpy(params: dict, device=None) -> dict:
    """The reference's LM parameters (``models/lm.py::init_params``, a
    nested dict of arrays as ``jax.device_get`` returns them, with the
    stacked ``units``) as the port's: the same tree of tensors on
    ``device``, bf16 leaves kept bf16 and the rest float32."""
    dev = resolve_device(device)
    return {k: lm_params_from_numpy(v, dev) if isinstance(v, dict)
            else _leaf(v, dev) for k, v in params.items()}


def lm_cache_from_numpy(cache: dict, device=None) -> dict:
    """The reference's decode cache (``init_cache`` / ``prefill`` /
    ``decode_step``) as the port's: floats keep bf16 or become float32,
    ``slot_pos`` stays int32. The conversion is ``lm_params_from_numpy``'s;
    this name stands beside it for the cache trees."""
    return lm_params_from_numpy(cache, device)


def state_to_numpy(state):
    """Any NamedTuple of tensors (nested, e.g. ``PooledState``) -> the same
    structure as a dict of numpy arrays (None fields stay None)."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if state is None:
        return None
    return {k: state_to_numpy(v) for k, v in state._asdict().items()}
