"""RG-LRU linear recurrence (counterpart of ``repro/kernels/rglru_scan.py``;
the plain version is the arithmetic of ``repro/kernels/ref.py::rglru_ref``).

Per channel, h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t with
a_t = exp(log_a_t), over log_a and x (B,S,D) float32 and an optional h0
(B,D). Returns h (B,S,D) and h_last (B,D), float32.

Dispatch goes by the device of ``x_in``: a CPU tensor runs the plain
version, a CUDA tensor a hand-written kernel (``csrc/rglru_scan.cu``) or
an error. The kernels replace the TPU kernel at
``repro/kernels/rglru_scan.py:72`` (``_rglru_kernel``), which walks
sequence blocks in grid order with the state in VMEM scratch. Here one
thread owns one (batch, channel) and walks S in order with the state in a
register. The scan moves 12 bytes per element (log_a and x in, h out) and
does a handful of operations, so it is bound by bytes; with only B * D
threads (8192 at recurrentgemma-9b's B 2, D 4096) the bytes must arrive
without each thread waiting on its own loads.

``uses_tma`` is the rule between the two kernels. Where it holds (D a
multiple of 4 and both inputs 16-byte aligned, as TMA requires), the
Hopper kernel runs: a producer warp streams (32 steps x 32 channels)
tiles of log_a and x through TMA into a 4-stage shared-memory ring and one
consumer warp per 32 channels walks them. Otherwise the first kernel runs,
each thread loading 16 steps ahead of the step it computes. Any D works
on either: there is no block divisibility.

Gradients: with grad mode on and an input that requires grad, a CUDA call
runs through ``RglruScan``, an ``autograd.Function`` whose backward is
``rglru_scan_bwd``: a reverse linear scan in the same source, chosen by
the same rule (``uses_tma`` over log_a, x, h and dh).
``rglru_bwd_kernel_sm90`` reads the forward's TMA ring in reverse: a block
per 32 channels of a batch row, tiles of 32 steps streamed from the last
backwards, eight gate warps computing every term but the carried
gradient, one warp walking the carry, dx and dlog_a stored by TMA. ``rglru_bwd_kernel`` (the first design, for
the shapes TMA cannot load) puts one thread on each (batch, channel),
walking S backwards with the carried gradient in a register. Both compute
each term alike, and each output is written by one thread in a fixed
order, so results repeat bitwise. It replaces no TPU kernel: the reference
trains through XLA's autodiff of ``lax.associative_scan``
(``repro/models/rglru.py::linear_scan``), and this is that gradient. At a
channel where 1 - exp(2 log_a) is 0 (log_a = 0, where the forward clamps)
the reference's gradient through the square root is +-inf for log_a (NaN
where the incoming gradient times x is 0) and 0 for x; the plain version
and the kernel give the same. A CPU call runs the plain recurrence, which
autograd differentiates as it stands.
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


def uses_tma(log_a: torch.Tensor, x_in: torch.Tensor,
             *more: torch.Tensor) -> bool:
    """Whether a CUDA call of these contiguous (B,S,D) inputs (the
    backward's also h and dh, in ``more``) runs the Hopper kernel (TMA
    wants 16-byte row strides and bases), else the first kernel: the
    dispatch rule of the forward and of the backward."""
    d = x_in.shape[-1]
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (log_a, x_in, *more))


def rglru_scan_bwd_plain(log_a: torch.Tensor, x_in: torch.Tensor,
                         h0: torch.Tensor | None, h: torch.Tensor,
                         dh: torch.Tensor, dh_last: torch.Tensor):
    """(dlog_a, dx (B,S,D), dh0 (B,D) or None) of ``rglru_scan_plain`` at
    (log_a, x_in, h0), whose output was h, for the gradients dh of h and
    dh_last of h_last: the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}
    (plus dh_last at S - 1), one step at a time, then over every step at
    once dx_t = g_t sqrt(max(1 - e_t, 0)) and dlog_a_t = g_t (a_t h_{t-1}
    - e_t x_t / sqrt(max(1 - e_t, 0))) with e_t = exp(2 log_a_t),
    h_{-1} = h0 or 0, and dh0 = a_0 g_0."""
    f32 = torch.float32
    log_a, x_in, h, dh = (t.to(f32) for t in (log_a, x_in, h, dh))
    a = torch.exp(log_a)
    e = torch.exp(2.0 * log_a)
    sq = torch.sqrt(torch.clamp_min(1.0 - e, 0.0))
    h_prev = torch.cat([(torch.zeros_like(h[:, :1]) if h0 is None
                         else h0.to(f32)[:, None]), h[:, :-1]], dim=1)
    s = x_in.shape[1]
    g = torch.empty((s, *dh_last.shape), dtype=f32, device=x_in.device)
    a_t, dh_t = a.transpose(0, 1), dh.transpose(0, 1)     # (S,B,D) views
    torch.add(dh_t[s - 1], dh_last.to(f32), out=g[s - 1])
    for t in range(s - 2, -1, -1):
        torch.addcmul(dh_t[t], a_t[t + 1], g[t + 1], out=g[t])
    g = g.transpose(0, 1)
    dlog_a = g * (a * h_prev - e * x_in / sq)
    return dlog_a, g * sq, (None if h0 is None else a[:, 0] * g[:, 0])


def _check_cuda(name, log_a, x_in, h0, *more):
    """Raise for what the CUDA kernels do not take: (B,S,D) log_a and x_in,
    h0 (B,D) or None, float32 on one card; ``more`` are further (name,
    tensor, shape) to check."""
    if x_in.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x_in.device}")
    check_args(log_a, x_in, h0, *more)


def check_args(log_a, x_in, h0, *more):
    """Raise for the shapes and dtypes the CUDA kernels do not take, on any
    device (``meta`` tensors too); ``more`` as ``_check_cuda``'s."""
    if x_in.dim() != 3 or log_a.shape != x_in.shape:
        raise ValueError(f"shapes log_a {tuple(log_a.shape)}, x_in "
                         f"{tuple(x_in.shape)}: want (B,S,D) twice")
    b, s, d = x_in.shape
    checks = [("log_a", log_a, (b, s, d)), ("x_in", x_in, (b, s, d)),
              ("h0", h0, (b, d)), *more]
    for what, t, shape in checks:
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} {tuple(t.shape)}: want {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what} is {t.dtype}: want float32")
        if t.device != x_in.device:
            raise ValueError(f"{what} is on {t.device}, x_in on "
                             f"{x_in.device}")
    if s < 1 or d < 1 or b > 65535:
        raise ValueError(f"unsupported B {b}, S {s}, D {d}")


def rglru_scan_bwd(log_a: torch.Tensor, x_in: torch.Tensor,
                   h0: torch.Tensor | None, h: torch.Tensor,
                   dh: torch.Tensor, dh_last: torch.Tensor):
    """(dlog_a, dx, dh0 or None) of ``rglru_scan`` (see
    ``rglru_scan_bwd_plain``). CPU tensors take the plain version; CUDA
    tensors launch one kernel (``uses_tma`` chooses which) and count the
    launch in ``rglru_scan_bwd.launches``."""
    if x_in.device.type == "cpu":
        return rglru_scan_bwd_plain(log_a, x_in, h0, h, dh, dh_last)
    b, s, d = x_in.shape
    _check_cuda("rglru_scan_bwd", log_a, x_in, h0, ("h", h, (b, s, d)),
                ("dh", dh, (b, s, d)), ("dh_last", dh_last, (b, d)))
    log_a, x_in, h, dh, dh_last = (t.contiguous() for t in
                                   (log_a, x_in, h, dh, dh_last))
    h0 = None if h0 is None else h0.contiguous()
    dlog_a, dx = torch.empty_like(x_in), torch.empty_like(x_in)
    dh0 = None if h0 is None else torch.empty_like(h0)
    lib = _build.library("rglru_scan")
    P = _build.ptr
    with torch.cuda.device(x_in.device):
        launch = (lib.rglru_scan_bwd_sm90_launch
                  if uses_tma(log_a, x_in, h, dh)
                  else lib.rglru_scan_bwd_launch)
        code = launch(P(log_a), P(x_in), P(h0), P(h), P(dh), P(dh_last),
                      P(dlog_a), P(dx), P(dh0), b, s, d,
                      _build.stream(x_in.device))
    _build.check(code, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return dlog_a, dx, dh0


rglru_scan_bwd.launches = 0


def _forward(log_a, x_in, h0):
    """(h, h_last) of the forward kernel on the card."""
    _check_cuda("rglru_scan", log_a, x_in, h0)
    b, s, d = x_in.shape
    log_a, x_in = log_a.contiguous(), x_in.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    h = torch.empty_like(x_in)
    h_last = torch.empty((b, d), dtype=torch.float32, device=x_in.device)
    lib = _build.library("rglru_scan")
    P = _build.ptr
    with torch.cuda.device(x_in.device):
        launch = (lib.rglru_scan_sm90_launch if uses_tma(log_a, x_in)
                  else lib.rglru_scan_launch)
        code = launch(P(log_a), P(x_in), P(h0), P(h), P(h_last), b, s, d,
                      _build.stream(x_in.device))
    _build.check(code, "rglru_scan")
    rglru_scan.launches += 1
    return h, h_last


class RglruScan(torch.autograd.Function):
    """``rglru_scan`` on the card with a gradient: the forward kernel, and
    ``rglru_scan_bwd`` from the saved inputs and output h."""

    @staticmethod
    def forward(ctx, log_a, x_in, h0):
        h, h_last = _forward(log_a, x_in, h0)
        ctx.save_for_backward(log_a, x_in, h0, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        log_a, x_in, h0, h = ctx.saved_tensors
        return rglru_scan_bwd(log_a, x_in, h0, h, dh, dh_last)


def rglru_scan(log_a: torch.Tensor, x_in: torch.Tensor,
               h0: torch.Tensor | None = None):
    """(h (B,S,D), h_last (B,D)) of the RG-LRU recurrence. CPU tensors take
    the plain version; CUDA tensors launch one kernel (``uses_tma``
    chooses which) and count the launch in ``rglru_scan.launches``. With
    grad mode on and an input that requires grad, a CUDA call runs through
    ``RglruScan``."""
    if x_in.device.type == "cpu":
        return rglru_scan_plain(log_a, x_in, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (log_a, x_in, h0)):
        return RglruScan.apply(log_a, x_in, h0)
    return _forward(log_a, x_in, h0)


rglru_scan.launches = 0


