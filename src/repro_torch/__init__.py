"""PyTorch / CUDA port of the LLM-routing system in ``repro``.

The layout mirrors ``repro`` module for module (``repro_torch/core/fgts.py``
is the counterpart of ``repro/core/fgts.py``). Importing the package builds
nothing: the CUDA kernels under ``kernels/csrc`` are compiled with ``nvcc``
on their first launch. See ``device.py`` for the dispatch rules.
"""
from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
