"""The variant tools' shared harness (``tools/bwd_variants.py``,
``tools/bwd_sm90_variants.py``, ``tools/scan_bwd_variants.py``).

A variant is a kernel source under ``src/repro_torch/kernels/csrc/``
patched at text anchors: (anchor, replacement) pairs applied in order, each
anchor found exactly once in the source as it stands, or the tool stops
with the anchor it did not find. ``build`` compiles one library per
variant (one ``nvcc`` each, all started together) into
``build/<tool>/``; ``install`` makes the port's wrappers launch one of
them in place of the library ``_build`` made. ``load`` imports a tool by
name (the tests read its ``PATCHES``).
"""
from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

TOOLS = Path(__file__).resolve().parent


def load(name: str):
    """``tools/<name>.py`` as a module."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def source_text(source: str) -> str:
    """``csrc/<source>.cu`` as it stands."""
    from repro_torch.kernels import _build
    return (_build.CSRC / f"{source}.cu").read_text()


def patched(src: str, patches, what: str) -> str:
    """``src`` with each (anchor, replacement) applied in order; stops
    (``SystemExit``, naming ``what``) at an anchor not found exactly once."""
    for anchor, repl in patches:
        if src.count(anchor) != 1:
            raise SystemExit(f"{what}: anchor found {src.count(anchor)} "
                             f"times: {anchor!r}")
        src = src.replace(anchor, repl)
    return src


def build(tool: str, source: str, patches: dict, names) -> dict[str, Path]:
    """A library per variant in ``names``, ``csrc/<source>.cu`` patched by
    ``patches[name]``; one nvcc each, together, into ``build/<tool>/``."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR.parent / tool
    out_dir.mkdir(parents=True, exist_ok=True)
    base = source_text(source)
    procs = {}
    for name in names:
        cu = out_dir / f"{source}_{name}.cu"
        cu.write_text(patched(base, patches[name], f"{tool}: {name}"))
        lib = out_dir / f"lib{source}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tool}: nvcc failed for {name}:\n"
                             f"{log.decode()}")
        libs[name] = lib
    return libs


def install(source: str, path: Path) -> None:
    """Make the wrappers of ``source``'s library launch the one at
    ``path``."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES[source].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _build._libs[source] = lib
