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

Gradients: with grad mode on and an input that requires grad, a CUDA call
runs through ``SsdScan``, an ``autograd.Function`` whose forward is the
kernel above and whose backward is ``ssd_scan_bwd``, chosen by the same
rule: bf16 at P 64, N 128, chunk 128 takes ``csrc/ssd_scan_bwd_sm90.cu``
(C.B^T once per (batch, chunk), the chunk states both ways on wgmma, then
a block per (batch, chunk, group of heads) for dC and one for dB, dx and
dlog_a, dB and dC summed over each group's heads in registers and over
the groups in order); everything else ``csrc/ssd_scan_bwd.cu`` (the
states on the CUDA cores, a block per (batch, chunk, head), dB and dC
summed over the heads in order). Both are deterministic. It replaces no
TPU kernel: the
reference trains through XLA's autodiff of ``repro/models/ssd.py::
ssd_chunked``, and this is that gradient, with one departure: the
reference forms exp(cum_i - cum_j) above the diagonal too and masks the
result, which overflows at mamba2-1.3b's decays and turns its gradient
into NaN (0 times inf); the port masks the exponent, so its gradient is
the function's, finite (ROADMAP, reference caveats). A CPU call runs the
plain version, which autograd differentiates; ``ssd_scan_bwd_plain`` is
the backward written out, the kernel's twin.
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
SM90_BWD_GROUP = 16          # heads a block of the Hopper backward's chunk kernels


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


def _causal_decay(cum: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) where j <= i, else 0 (..., L, L). The mask goes
    on the exponent: past the diagonal cum_i - cum_j > 0 grows to
    (L - 1) |log_a| and overflows, and a masked-out inf would turn the
    gradient of the unselected branch (0 times inf) into NaN."""
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.exp(torch.where(mask, diff, float("-inf")))


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
        m = _causal_decay(cum, mask)                       # (b,h,L,L)
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


def ssd_scan_bwd_plain(x: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor,
                       log_a: torch.Tensor, dt: torch.Tensor,
                       h0: torch.Tensor | None, dy: torch.Tensor,
                       dh_last: torch.Tensor | None, *,
                       chunk: int = DEFAULT_CHUNK):
    """(dx, dB, dC, dlog_a, ddt, dh0) of ``ssd_scan_plain`` at (x, bt, ct,
    log_a, dt, h0) for the gradients dy of y and dh_last of h_last (None:
    zero), written out by hand: the backward kernel's twin. dx, dB and dC
    come back in the dtypes of x, bt and ct (rounded once from fp32, as
    the transpose of ``astype``), the rest in fp32; dh0 is None without
    h0. The forward's chunk-entry states H_{c-1} come from a first pass;
    then, walking the chunks backwards with dH_c the gradient reaching
    the state after chunk c (dh_last after the last):

        dH_{c-1} = e^{cum_L} dH_c + sum_i e^{cum_i} dy_i C_i^T
        bracket_j = sum_{i>=j} CB_ij e^{cum_i-cum_j} dy_i
                    + e^{cum_L-cum_j} dH_c B_j
        dx_j = dt_j bracket_j,   ddt_j = x_j . bracket_j
        dCB_ij = (dy_i . x_j) e^{cum_i-cum_j} dt_j          (j <= i)
        dC_i = sum_j dCB_ij B_j + e^{cum_i} H_{c-1}^T dy_i   (over heads)
        dB_j = sum_i dCB_ij C_i + e^{cum_L-cum_j} dt_j dH_c^T x_j

    and dlog_a the reverse cumsum, within each chunk, of dcum: with
    T_ij = dCB_ij CB_ij and U_j = e^{cum_L-cum_j} dt_j x_j . (dH_c B_j),
    dcum_i = sum_j T_ij - sum_k T_ki + C_i . (e^{cum_i} H_{c-1}^T dy_i)
    - U_i, plus sum_j U_j + e^{cum_L} <H_{c-1}, dH_c> at the chunk's last
    step. Only pairs j <= i are formed, so every exponential is at most 1
    (for log_a <= 0). Steps past S (zero-padded, log_a = dt = 0) are
    dropped from the outputs."""
    b, s, h, p = x.shape
    n = bt.shape[-1]
    f32 = torch.float32
    l = chunk
    nc = -(-s // l)
    pad = nc * l - s
    xs, bs, cs, las, dts, dys = (_pad_seq(t.to(f32), pad)
                                 for t in (x, bt, ct, log_a, dt, dy))
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    chunks = []
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    for c in range(nc):                       # the forward's entry states
        sl = slice(c * l, (c + 1) * l)
        xc = xs[:, sl].permute(0, 2, 1, 3)                 # (b,h,L,p)
        bc, cc = bs[:, sl], cs[:, sl]                      # (b,L,n)
        d = dts[:, sl].transpose(1, 2)                     # (b,h,L)
        cum = torch.cumsum(las[:, sl].transpose(1, 2), dim=-1)
        dec_out = torch.exp(cum[..., -1:] - cum)           # (b,h,L)
        chunks.append((xc, bc, cc, d, cum, dec_out, state))
        s_new = (xc * (dec_out * d)[..., None]).transpose(-1, -2) @ bc[:, None]
        state = torch.exp(cum[..., -1])[..., None, None] * state + s_new
    dh = (torch.zeros_like(state) if dh_last is None else dh_last.to(f32))
    dx, dbt, dct, dla, ddt = [], [], [], [], []
    for c in range(nc - 1, -1, -1):
        xc, bc, cc, d, cum, dec_out, h_prev = chunks[c]
        dyc = dys[:, c * l:(c + 1) * l].permute(0, 2, 1, 3)   # (b,h,L,p)
        e = _causal_decay(cum, mask)                       # (b,h,i,j)
        cb = (cc @ bc.transpose(1, 2))[:, None]            # (b,1,i,j)
        e_in = torch.exp(cum)                              # (b,h,L)
        dhb = bc[:, None] @ dh.transpose(-1, -2)           # (b,h,L,p)
        bracket = ((cb * e).transpose(-1, -2) @ dyc
                   + dec_out[..., None] * dhb)
        dx.append(d[..., None] * bracket)
        ddt.append((xc * bracket).sum(-1))
        dcb = (dyc @ xc.transpose(-1, -2)) * e * d[..., None, :]
        dc_inter = e_in[..., None] * (dyc @ h_prev)        # (b,h,L,n)
        dct.append((dcb @ bc[:, None] + dc_inter).sum(1))
        dbt.append((dcb.transpose(-1, -2) @ cc[:, None]
                    + (dec_out * d)[..., None] * (xc @ dh)).sum(1))
        t = dcb * cb
        u = dec_out * d * (xc * dhb).sum(-1)               # (b,h,L)
        dcum = (t.sum(-1) - t.sum(-2) + (dc_inter * cc[:, None]).sum(-1)
                - u)
        dcum[..., -1] += u.sum(-1) + torch.exp(cum[..., -1]) * (
            h_prev * dh).sum((-1, -2))
        dla.append(dcum.flip(-1).cumsum(-1).flip(-1))
        dh = (torch.exp(cum[..., -1])[..., None, None] * dh
              + (e_in[..., None] * dyc).transpose(-1, -2) @ cc[:, None])
    dx = torch.cat(dx[::-1], dim=-2).permute(0, 2, 1, 3)[:, :s]
    dx = dx.to(x.dtype).contiguous()
    dbt = torch.cat(dbt[::-1], dim=1)[:, :s].to(bt.dtype).contiguous()
    dct = torch.cat(dct[::-1], dim=1)[:, :s].to(ct.dtype).contiguous()
    dla = torch.cat(dla[::-1], dim=-1).transpose(1, 2)[:, :s].contiguous()
    ddt = torch.cat(ddt[::-1], dim=-1).transpose(1, 2)[:, :s].contiguous()
    return dx, dbt, dct, dla, ddt, (None if h0 is None else dh)


def _check_cuda(x, bt, ct, log_a, dt, h0, chunk):
    """Raise ``ValueError`` for what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    check_args(x, bt, ct, log_a, dt, h0, chunk)


def check_args(x, bt, ct, log_a, dt, h0, chunk):
    """Raise ``ValueError`` for the shapes, dtypes and chunks the kernels
    do not take, on any device (``meta`` tensors too)."""
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


def _forward(x, bt, ct, log_a, dt, h0, chunk):
    """(y, h_last) of the forward kernels on the card."""
    _check_cuda(x, bt, ct, log_a, dt, h0, chunk)
    b, s, h, p = x.shape
    n = bt.shape[-1]
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


def ssd_scan_bwd(x: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor,
                 log_a: torch.Tensor, dt: torch.Tensor,
                 h0: torch.Tensor | None, dy: torch.Tensor,
                 dh_last: torch.Tensor | None, *,
                 chunk: int = DEFAULT_CHUNK):
    """(dx, dB, dC, dlog_a, ddt, dh0 or None) of ``ssd_scan`` (see
    ``ssd_scan_bwd_plain``). CPU tensors take the plain version; CUDA
    tensors launch, by ``uses_sm90``, ``csrc/ssd_scan_bwd_sm90.cu`` (bf16
    at P 64, N 128, chunk 128; six kernels; x, B and C must meet the TMA
    rule, else ``ValueError``) or ``csrc/ssd_scan_bwd.cu`` (three kernels),
    and count one launch in ``ssd_scan_bwd.launches``. It takes every input
    the forward takes (fp32 or bf16 x/B/C through their strides, chunks of
    16 to 128, N <= 128, ragged S, h0) and raises ``ValueError`` for the
    rest before any launch. Scratch on the card, with nc = ceil(S / chunk):
    the Hopper kernels keep the chunk-entry states, their gradients and dy
    as three bf16 pieces each, 3 x 3 x B * nc * H * 128 * 64 bf16, C.B^T
    twice, 2 x B * nc * 128 * 128 fp32, and dB and dC per group of
    ``SM90_BWD_GROUP`` heads, 2 x B * S * ceil(H / 16) * N fp32 (603, 8
    and 34 MB at mamba2-1.3b's B 2, S 4096); the first design the states
    and their gradients, 2 x B * nc * H * P * N fp32, and each head's dB
    and dC, 2 x B * S * H * N fp32."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, bt, ct, log_a, dt, h0, dy, dh_last,
                                  chunk=chunk)
    _check_cuda(x, bt, ct, log_a, dt, h0, chunk)
    b, s, h, p = x.shape
    n = bt.shape[-1]
    for name, t, shape in (("dy", dy, (b, s, h, p)),
                           ("dh_last", dh_last, (b, h, p, n))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"{shape} float32")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    x, bt, ct, log_a, dt = (_inner_contiguous(t)
                            for t in (x, bt, ct, log_a, dt))
    h0, dy, dh_last = (None if t is None else t.contiguous()
                       for t in (h0, dy, dh_last))
    sm90 = uses_sm90(x.dtype, p, n, chunk)
    outer = []
    for name, t, axes in (("x", x, 3), ("bt", bt, 2), ("ct", ct, 2)):
        if sm90:
            _check_tma(name, t, axes)
        outer += _outer_strides(t, sm90, axes)
    if sm90 and dy.data_ptr() % 16:
        # TMA reads dy from a 16-byte aligned address: an offset view of an
        # upstream gradient is copied, not refused
        dy = torch.empty_like(dy).copy_(dy)
    L = ctypes.c_longlong
    strides = [L(st) for st in (*outer, *log_a.stride()[:3],
                                *dt.stride()[:3])]
    f32, dev = torch.float32, x.device
    nc = -(-s // chunk)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    dbt = torch.empty((b, s, n), dtype=bt.dtype, device=dev)
    dct = torch.empty((b, s, n), dtype=ct.dtype, device=dev)
    dla = torch.empty((b, s, h), dtype=f32, device=dev)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dh0 = None if h0 is None else torch.empty_like(h0)
    P = _build.ptr
    if sm90:
        groups = -(-h // SM90_BWD_GROUP)
        cb = torch.empty((2, b, nc, chunk, chunk), dtype=f32, device=dev)
        pieces = torch.empty((3, b, nc, h, 3, chunk, p), dtype=torch.bfloat16,
                             device=dev)
        hd = torch.empty((b, nc, h), dtype=f32, device=dev)
        rows = torch.empty((b, s, h), dtype=f32, device=dev)
        parts = torch.empty((2, b, groups, s, n), dtype=f32, device=dev)
        lib = _build.library("ssd_scan_bwd_sm90")
        with torch.cuda.device(dev):
            code = lib.ssd_scan_bwd_sm90_launch(
                P(x), P(bt), P(ct), P(log_a), P(dt), P(h0), P(dy),
                P(dh_last), P(dx), P(dbt), P(dct), P(dla), P(ddt), P(dh0),
                P(cb), P(pieces[0]), P(pieces[1]), P(pieces[2]), P(hd),
                P(rows), P(parts[0]), P(parts[1]), b, s, h, SM90_BWD_GROUP,
                *strides, _build.stream(dev))
        _build.check(code, "ssd_scan_bwd")
        ssd_scan_bwd.launches += 1
        return dx, dbt, dct, dla, ddt, dh0
    states = torch.empty((2, b, nc, h, p, n), dtype=f32, device=dev)
    parts = torch.empty((2, b, s, h, n), dtype=f32, device=dev)
    lib = _build.library("ssd_scan_bwd")
    with torch.cuda.device(dev):
        code = lib.ssd_scan_bwd_launch(
            P(x), P(bt), P(ct), P(log_a), P(dt), P(h0), P(dy), P(dh_last),
            P(dx), P(dbt), P(dct), P(dla), P(ddt), P(dh0), P(states[0]),
            P(states[1]), P(parts[0]), P(parts[1]), b, s, h, p, n, chunk,
            *strides, int(x.dtype == torch.bfloat16), _build.stream(dev))
    _build.check(code, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, dbt, dct, dla, ddt, dh0


ssd_scan_bwd.launches = 0


class SsdScan(torch.autograd.Function):
    """``ssd_scan`` on the card with a gradient: the forward kernels, and
    ``ssd_scan_bwd`` from the saved inputs."""

    @staticmethod
    def forward(ctx, x, bt, ct, log_a, dt, h0, chunk):
        y, h_last = _forward(x, bt, ct, log_a, dt, h0, chunk)
        ctx.save_for_backward(x, bt, ct, log_a, dt, h0)
        ctx.chunk = chunk
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, bt, ct, log_a, dt, h0 = ctx.saved_tensors
        grads = ssd_scan_bwd(x, bt, ct, log_a, dt, h0, dy, dh_last,
                             chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor,
             log_a: torch.Tensor, dt: torch.Tensor,
             h0: torch.Tensor | None = None, *, chunk: int = DEFAULT_CHUNK):
    """(y (B,S,H,P), h_last (B,H,P,N)) of the chunked SSD. CPU tensors take
    the plain version; CUDA tensors launch the kernel and count the launch
    in ``ssd_scan.launches``. With grad mode on and an input that requires
    grad, a CUDA call runs through ``SsdScan``."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, bt, ct, log_a, dt, h0, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, bt, ct, log_a, dt, h0)):
        return SsdScan.apply(x, bt, ct, log_a, dt, h0, chunk)
    return _forward(x, bt, ct, log_a, dt, h0, chunk)


ssd_scan.launches = 0
