"""Device selection for the PyTorch port.

Every function of the port that creates tensors takes ``device=None``,
which means ``default_device()``: the CUDA card. There is no silent CPU
fallback: without a card ``default_device()`` raises, and a caller that
wants the CPU (the parity tests, a debugging session) says so with
``device="cpu"``. On a CPU tensor every kernel wrapper runs its plain
PyTorch version; on a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    """The CUDA card, or an error that names the CPU opt-in."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; pass "
            "device=\"cpu\" explicitly to run the plain PyTorch versions on "
            "the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``default_device()``; anything else -> ``torch.device``."""
    return default_device() if device is None else torch.device(device)


def as_f32(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor, numpy array or number.

    numpy defaults to float64; JAX (and this port) compute in float32, so
    every array entering the port is cast here rather than letting float64
    creep through the arithmetic. A numpy array is copied (it may be
    read-only, as ``jax.device_get`` returns it)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)
