"""Mamba-2 chunked SSD scan (counterpart of ``repro/kernels/ssd_scan.py``;
the plain version is that Pallas kernel's chunked arithmetic).

x (B,S,H,P), B and C (B,S,N) shared across heads, log_a and dt (B,S,H),
an optional h0 (B,H,P,N). Per chunk of ``chunk`` steps (padded steps past
S have log_a = dt = 0: no decay, no increment):

    cum     = cumsum(log_a)
    W[i,j]  = (C_i . B_j) exp(cum_i - cum_j) dt_j       for j <= i
    y_i     = sum_j W[i,j] x_j + exp(cum_i) (C_i . state)
    state'  = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T

Returns y (B,S,H,P) and h_last (B,H,P,N), both float32.

Dispatch goes by the device of ``x``: a CPU tensor runs the plain version,
a CUDA tensor a hand-written kernel of ``csrc/ssd_scan.cu`` or an error.
The kernels replace the TPU kernel at ``repro/kernels/ssd_scan.py:109``
(``_ssd_kernel``), whose sequential chunk axis carries the state in VMEM.
The function is bound by operations (~5.25 MFLOP per (batch*head, chunk)
and 2.1 MFLOP of C.B^T per (batch, chunk) at mamba2-1.3b's shape); the
source says how each kernel's grid and shared memory are laid out. x, B and
C may be float32 or bfloat16 (one type for the three) and are read through
their batch and sequence strides, so the model's column slices of its conv
output go in without a copy; log_a, dt and h0 are float32. The kernel is
chosen by a rule on dtype and shape:

* bf16 x/B/C with P 64, N 128 and chunk 128 (mamba2-1.3b's prefill): the
  Hopper kernels (``ssd_kernel_cb_sm90`` computes C.B^T once per (batch,
  chunk) into a scratch, then ``ssd_kernel_sm90`` walks the chunks of one
  (batch, head) on wgmma, fed by TMA). Every product with an fp32 operand
  (W, the state, x * dec) takes three bf16 pieces of it, so the products
  stay exact and only the fp32 summation order differs from the plain
  version. TMA needs x, B and C at 16-byte aligned addresses with batch,
  sequence (and for x head) strides of a multiple of 8 elements; a tensor
  that breaks the rule raises ``ValueError`` (there is no fallback).
* everything else (fp32, other widths or chunks): the SIMT kernel on the
  CUDA cores (bf16 widened on load), chunks of 16 to 128 steps in
  multiples of 16 and N <= 128.

One wrapper call counts one launch, whichever kernels it runs.

There is no backward kernel yet. A CUDA call with grad mode on and an input
that requires grad raises ``NotImplementedError``: the kernel writes its
outputs into ``torch.empty`` tensors with no ``grad_fn``, so without the
refusal every parameter before the scan would silently get no gradient.
A CPU call runs the plain version, which autograd differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _check_tma, _inner_contiguous, _outer_strides

DEFAULT_CHUNK = 128
MAX_CHUNK = 128         # the kernel's shared-memory tiles
MAX_STATE = 128
DTYPES = (torch.float32, torch.bfloat16)
SM90_TILE = (64, 128, 128)   # (P, N, chunk) of the bf16 Hopper kernels


def uses_sm90(dtype, p: int, n: int, chunk: int) -> bool:
    """Whether a CUDA call of these inputs runs the bf16 Hopper kernels
    (else the SIMT kernel): the dispatch rule, by dtype and shape."""
    return dtype == torch.bfloat16 and (p, n, chunk) == SM90_TILE



def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    shape = list(t.shape)
    shape[1] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def ssd_scan_plain(x: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor,
                   log_a: torch.Tensor, dt: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   chunk: int = DEFAULT_CHUNK):
    """The Pallas kernel's arithmetic: a loop over chunks, vectorised over
    (B, H), with zero-padded steps past S."""
    b, s, h, p = x.shape
    n = bt.shape[-1]
    f32 = torch.float32
    l = chunk
    nc = -(-s // l)
    pad = nc * l - s
    x, bt, ct, log_a, dt = (_pad_seq(t.to(f32), pad)
                            for t in (x, bt, ct, log_a, dt))
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * l, (c + 1) * l)
        xc = x[:, sl].permute(0, 2, 1, 3)                  # (b,h,L,p)
        bc, cc = bt[:, sl], ct[:, sl]                      # (b,L,n)
        la = log_a[:, sl].transpose(1, 2)                  # (b,h,L)
        d = dt[:, sl].transpose(1, 2)
        cum = torch.cumsum(la, dim=-1)
        m = torch.where(mask, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)                               # (b,h,L,L)
        cb = cc @ bc.transpose(1, 2)                       # (b,L,L)
        w = cb[:, None] * m * d[..., None, :]
        y_intra = w @ xc                                   # (b,h,L,p)
        y_inter = torch.exp(cum)[..., None] * (
            cc[:, None] @ state.transpose(-1, -2))         # (b,h,L,p)
        ys.append(y_intra + y_inter)
        dec_out = torch.exp(cum[..., -1:] - cum) * d       # (b,h,L)
        xw = xc * dec_out[..., None]
        s_new = xw.transpose(-1, -2) @ bc[:, None]         # (b,h,p,n)
        state = torch.exp(cum[..., -1])[..., None, None] * state + s_new
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :s]
    return y.contiguous(), state


def ssd_scan(x: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor,
             log_a: torch.Tensor, dt: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = DEFAULT_CHUNK):
    """(y (B,S,H,P), h_last (B,H,P,N)) of the chunked SSD. CPU tensors take
    the plain version; CUDA tensors launch the kernel and count the launch
    in ``ssd_scan.launches``."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, bt, ct, log_a, dt, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, bt, ct, log_a, dt, h0)):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet: its gradient on the card "
            "comes with the next slice (ROADMAP Queue 1 item 4.5); the "
            "kernel's outputs would carry no gradient, so a grad-requiring "
            "input is refused (run under torch.no_grad, or on the CPU)")
    if x.dim() != 4 or bt.dim() != 3 or ct.shape != bt.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, bt {tuple(bt.shape)}, "
                         f"ct {tuple(ct.shape)}: want (B,S,H,P), (B,S,N) x2")
    b, s, h, p = x.shape
    n = bt.shape[-1]
    if (tuple(bt.shape[:2]) != (b, s) or tuple(log_a.shape) != (b, s, h)
            or dt.shape != log_a.shape):
        raise ValueError(f"shapes x {tuple(x.shape)}, bt {tuple(bt.shape)}, "
                         f"log_a {tuple(log_a.shape)}, dt {tuple(dt.shape)} "
                         f"do not agree")
    if h0 is not None and tuple(h0.shape) != (b, h, p, n):
        raise ValueError(f"h0 {tuple(h0.shape)}: want {(b, h, p, n)}")
    if x.dtype not in DTYPES or bt.dtype != x.dtype or ct.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {bt.dtype}, {ct.dtype}: want "
                         f"one of {DTYPES} for x, bt and ct")
    for name, t in (("log_a", log_a), ("dt", dt), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: want float32")
    for name, t in (("bt", bt), ("ct", ct), ("log_a", log_a), ("dt", dt),
                    ("h0", h0)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if chunk % 16 or not 16 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes multiples of 16 "
                         f"up to {MAX_CHUNK}")
    if not 1 <= n <= MAX_STATE or s < 1 or p < 1 or h < 1:
        raise ValueError(f"unsupported S {s}, H {h}, P {p} or N {n} (N <= "
                         f"{MAX_STATE})")
    x, bt, ct, log_a, dt = (_inner_contiguous(t)
                            for t in (x, bt, ct, log_a, dt))
    h0 = None if h0 is None else h0.contiguous()
    sm90 = uses_sm90(x.dtype, p, n, chunk)
    outer = []
    for name, t, axes in (("x", x, 3), ("bt", bt, 2), ("ct", ct, 2)):
        if sm90:
            _check_tma(name, t, axes)
        outer += _outer_strides(t, sm90, axes)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    L = ctypes.c_longlong
    strides = [L(st) for st in (*outer, *log_a.stride()[:3],
                                *dt.stride()[:3])]
    lib = _build.library("ssd_scan")
    P = _build.ptr
    with torch.cuda.device(x.device):
        if sm90:
            cb = torch.empty((b, -(-s // chunk), chunk, chunk),
                             dtype=torch.float32, device=x.device)
            code = lib.ssd_scan_sm90_launch(
                P(x), P(bt), P(ct), P(log_a), P(dt), P(h0), P(y),
                P(h_last), P(cb), b, s, h, *strides,
                _build.stream(x.device))
        else:
            code = lib.ssd_scan_launch(
                P(x), P(bt), P(ct), P(log_a), P(dt), P(h0), P(y),
                P(h_last), b, s, h, p, n, chunk, *strides,
                int(x.dtype == torch.bfloat16), _build.stream(x.device))
    _build.check(code, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_last


ssd_scan.launches = 0
