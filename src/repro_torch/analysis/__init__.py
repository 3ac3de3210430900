"""repro-lint for the PyTorch port: static analysis of ``src/repro_torch``
(counterpart of ``repro/analysis``).

The reference's engine, finding format, baseline mechanics, CLI and five
passes, with each rule whose meaning carries over to PyTorch under the
reference's id and each JAX- or TPU-only rule replaced by the CUDA-graph
or Hopper hazard that plays its part (the README's table maps them).
Stdlib-only (``ast`` + ``json``): the CLI imports neither torch nor the
port. The runtime helper :mod:`repro_torch.analysis.retrace` is imported
lazily, so ``python -m repro_torch.analysis`` never pulls it in.

Layout
------
``engine``          Finding dataclass, module loader, baseline matching.
``torchast``        Alias resolution + capture-reachability approximation.
``passes``          The five registered passes (see ``passes.REGISTRY``).
``retrace``         Runtime ``assert_flat`` context manager (graph counts).
"""
from .engine import AnalysisContext, Finding, load_modules, run_passes

__all__ = ["AnalysisContext", "Finding", "load_modules", "run_passes"]
