"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds). Libraries are built on first
use, never at import, into ``build/repro_torch_kernels/`` at the root of
the checkout; a library newer than its source and the shared headers
(``csrc/*.cuh``) is reused. ``build_all``
starts one ``nvcc`` per source at once.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``: a bare Python int would be cut to 32 bits) and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

# C signatures: library -> {function: argtypes}; every function returns int
SIGNATURES = {
    "dueling_select": {
        # x, a, thetas, tilt, mask, a1, a2, B, K, d, tilt_stride,
        # mask_stride, distinct, stream
        "dueling_select_launch": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    },
    "dueling_score": {
        # x, a, thetas, out, B, K, d, J, configuration, grid x, y, z,
        # stream
        "dueling_score_launch": [P, P, P, P, I, I, I, I, I, I, I, I, P],
    },
    "sgld_potential": {
        # theta, x, a1, a2, y, pref, rows, valid, a_emb, mask, costs, g,
        # scratch, out, C, m, K, d, j, eta, mu, configuration, cluster
        # size, rows per block, stream
        "sgld_potential_fwd_launch": [P, P, P, P, P, P, P, P, P, P, P, P, P,
                                      P, I, I, I, I, I, F, F, I, I, I, P],
        "sgld_potential_grad_launch": [P, P, P, P, P, P, P, P, P, P, P, P, P,
                                       P, I, I, I, I, I, F, F, I, I, I, P],
        # theta, x, a1, a2, y, is_duel, rows, valid, a_emb, g, out, C, m,
        # d, eta, cluster size, rows per block, rows per group, stream
        "sgld_mixed_fwd_launch": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, F,
                                  I, I, I, P],
        "sgld_mixed_grad_launch": [P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                                   F, I, I, I, P],
    },
    "flash_attention": {
        # q, k, v, o, B, H, KV, S, T, D, (batch, head, seq) strides of q,
        # k, v and o, scale, softcap, causal, window, stream; fp32 / bf16
        "flash_attention_launch": [P, P, P, P, I, I, I, I, I, I, *[L] * 12,
                                   F, F, I, I, P],
        "flash_attention_sm90_launch": [P, P, P, P, I, I, I, I, I, I,
                                        *[L] * 12, F, F, I, I, P],
    },
    "ssd_scan": {
        # x, bt, ct, log_a, dt, h0, y, h_last, B, S, H, P, N, chunk,
        # (batch, seq, head) strides of x, (batch, seq) of bt and ct,
        # (batch, seq, head) of log_a and dt, is_bf16, stream
        "ssd_scan_launch": [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                            *[L] * 13, I, P],
        # x, bt, ct, log_a, dt, h0, y, h_last, cb scratch, B, S, H, the
        # same 13 strides, stream; bf16 at P 64, N 128, chunk 128
        "ssd_scan_sm90_launch": [P, P, P, P, P, P, P, P, P, I, I, I,
                                 *[L] * 13, P],
    },
    "rglru_scan": {
        # log_a, x, h0, h, h_last, B, S, D, stream
        "rglru_scan_launch": [P, P, P, P, P, I, I, I, P],
        "rglru_scan_sm90_launch": [P, P, P, P, P, I, I, I, P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the repro_torch "
                           "kernels are built from source on first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or any shared header
    (``csrc/*.cuh``)."""
    out = _target(name)
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any(built < src.stat().st_mtime
               for src in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))


def _compile(names: list[str]) -> None:
    """One nvcc per source, all started together; raise on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out.decode()}")
        else:
            os.replace(tmp, _target(name))
    if errors:
        raise RuntimeError("\n".join(errors))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every kernel library."""
    with _lock:
        missing = [n for n in SIGNATURES if n not in _libs]
        stale = [n for n in missing if _stale(n)]
        if stale:
            _compile(stale)
        for n in missing:
            _libs[n] = _load(n)
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                if _stale(name):
                    _compile([name])
                _libs[name] = _load(name)
            lib = _libs[name]
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
