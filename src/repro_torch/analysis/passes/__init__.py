"""Pass registry for the port's repro-lint: the reference's five pass
names, in its order (``repro/analysis/passes/__init__.py``).

Each pass is ``(name, callable(AnalysisContext) -> Iterable[Finding])``.
Order is cosmetic — findings are globally sorted by the engine.
"""
from . import (partition_coverage, prng, protocol_kernel, retrace_hazard,
               trace_hazard)

REGISTRY = [
    ("trace-hazard", trace_hazard.run),
    ("prng-hygiene", prng.run),
    ("retrace-hazard", retrace_hazard.run),
    ("partition-coverage", partition_coverage.run),
    ("protocol-kernel", protocol_kernel.run),
]

__all__ = ["REGISTRY"]
