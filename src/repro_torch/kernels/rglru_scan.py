"""RG-LRU linear recurrence (counterpart of ``repro/kernels/rglru_scan.py``;
the plain version is the arithmetic of ``repro/kernels/ref.py::rglru_ref``).

Per channel, h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t with
a_t = exp(log_a_t), over log_a and x (B,S,D) float32 and an optional h0
(B,D). Returns h (B,S,D) and h_last (B,D), float32.

Dispatch goes by the device of ``x_in``: a CPU tensor runs the plain
version, a CUDA tensor the hand-written kernel (``csrc/rglru_scan.cu``) or
an error. The kernel replaces the TPU kernel at
``repro/kernels/rglru_scan.py:72`` (``_rglru_kernel``), which walks
sequence blocks in grid order with the state in VMEM scratch. Here one
thread owns one (batch, channel) and walks S in order with the state in a
register; neighbouring threads take neighbouring channels, so every load
and store is coalesced. The scan moves 12 bytes per element (log_a and x
in, h out) and does a handful of operations, so it is bound by bytes; with
only B * D threads in flight (8192 at recurrentgemma-9b's B 2, D 4096) a
plain loop would wait on each load, so the kernel loads 16 steps ahead of
the step it computes (loads do not depend on h). Any D works: there is no
block divisibility.
"""
from __future__ import annotations

import torch

from . import _build


def rglru_scan_plain(log_a: torch.Tensor, x_in: torch.Tensor,
                     h0: torch.Tensor | None = None):
    """The sequential recurrence, one step at a time."""
    f32 = torch.float32
    log_a, x_in = log_a.to(f32), x_in.to(f32)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 0.0)) * x_in
    h = (torch.zeros_like(x_in[:, 0]) if h0 is None else h0.to(f32))
    hs = []
    for t in range(x_in.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan(log_a: torch.Tensor, x_in: torch.Tensor,
               h0: torch.Tensor | None = None):
    """(h (B,S,D), h_last (B,D)) of the RG-LRU recurrence. CPU tensors take
    the plain version; CUDA tensors launch the kernel and count the launch
    in ``rglru_scan.launches``."""
    if x_in.device.type == "cpu":
        return rglru_scan_plain(log_a, x_in, h0)
    if x_in.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {x_in.device}")
    if x_in.dim() != 3 or log_a.shape != x_in.shape:
        raise ValueError(f"shapes log_a {tuple(log_a.shape)}, x_in "
                         f"{tuple(x_in.shape)}: want (B,S,D) twice")
    b, s, d = x_in.shape
    if h0 is not None and tuple(h0.shape) != (b, d):
        raise ValueError(f"h0 {tuple(h0.shape)}: want ({b}, {d})")
    for name, t in (("log_a", log_a), ("x_in", x_in), ("h0", h0)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: want float32")
        if t.device != x_in.device:
            raise ValueError(f"{name} is on {t.device}, x_in on "
                             f"{x_in.device}")
    if s < 1 or d < 1 or b > 65535:
        raise ValueError(f"unsupported B {b}, S {s}, D {d}")
    log_a, x_in = log_a.contiguous(), x_in.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    h = torch.empty_like(x_in)
    h_last = torch.empty((b, d), dtype=torch.float32, device=x_in.device)
    lib = _build.library("rglru_scan")
    P = _build.ptr
    with torch.cuda.device(x_in.device):
        code = lib.rglru_scan_launch(P(log_a), P(x_in), P(h0), P(h),
                                     P(h_last), b, s, d,
                                     _build.stream(x_in.device))
    _build.check(code, "rglru_scan")
    rglru_scan.launches += 1
    return h, h_last


rglru_scan.launches = 0
