"""PyTorch / CUDA port of the LLM-routing system in ``repro``.

The layout mirrors ``repro`` module for module (``repro_torch/core/fgts.py``
is the counterpart of ``repro/core/fgts.py``). Importing the package builds
nothing: the CUDA kernels under ``kernels/csrc`` are compiled with ``nvcc``
on their first launch. See ``device.py`` for the dispatch rules.
"""
__all__ = ["default_device", "resolve_device"]


def __getattr__(name):
    # torch is imported on first use, so the stdlib-only lint
    # (``python -m repro_torch.analysis``) starts without it
    if name in __all__:
        from . import device
        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
