"""Flash attention: causal / sliding-window / bidirectional GQA attention
with the Gemma-2 logit soft cap (counterpart of
``repro/kernels/flash_attention.py``; the plain version is the arithmetic
of ``repro/kernels/ref.py::attention_ref``).

q is (B,H,S,D), k and v are (B,KV,T,D) with H % KV == 0; head h reads kv
head h // (H/KV). Scores are scaled (D^-0.5 by default), soft-capped
(cap*tanh(s/cap)) and masked by index: key j < T, then ``causal`` j <= i,
then ``window`` j > i - window. A query row with no live key gives the
mean of v over the T keys, as the dense oracle's uniform softmax over its
-1e30 fill does (the TPU kernel's value there depends on its tiling; it is
not copied).

Dispatch goes by the device of ``q``: a CPU tensor runs the plain version,
a CUDA tensor a hand-written kernel of ``csrc/flash_attention.cu`` or an
error, chosen by dtype. Both kernels count
their launches in ``flash_attention.launches`` and read every tensor
through its batch, head and sequence strides (the head dim must be
contiguous), so the model's (B,S,H,D) projections go in as
``transpose(1, 2)`` views without a copy, and the output takes q's layout.

* fp32: the parity path, fp32 FMAs on the CUDA cores, accumulating in
  fp32 (within 2e-5 of the dense oracle). Any head dim from 1 to 256: the
  kernel is built for 32, 64, 128 and 256 and runs D on the next of them,
  its loads zero-filling the columns past D (zeros add exactly nothing to
  an fp32 fma chain) and its stores skipping them.
* bf16: the Hopper kernel (wgmma for both products, fed by TMA through an
  mbarrier ring); scores and sums in fp32, p rounded to bf16 before P.V.
  TMA needs q, k and v each at a 16-byte aligned address with batch, head
  and sequence strides that are multiples of 16 bytes (8 elements); a
  tensor that breaks the rule raises ``ValueError`` (there is no fallback).
  Head dims 32, 64, 128 and 256.

Gradients: when grad mode is on and q, k or v requires grad,
``flash_attention`` runs through ``FlashAttention``, an
``autograd.Function`` whose forward also keeps the row log-sum-exp ``lse``
(B,H,S) of the scaled, soft-capped, masked scores and whose backward is
``flash_attention_bwd``, which recomputes P = exp(s - lse) from q and k
(the plain version on the CPU). On the card ``bwd_plan`` picks by dtype
and head dim: bf16 at head dims 64, 128 and 256 runs
``csrc/flash_attention_bwd_sm90.cu``, FlashAttention-3's backward on the
tensor cores (a dQ pass, then a dK/dV pass; wgmma and TMA; P and dS
rounded to bf16 before their products, as the reference's bf16 autodiff
rounds them); fp32, and bf16 at head dim 32, run
``csrc/flash_attention_bwd.cu``, FlashAttention-2's backward on the CUDA
cores (bf16 widens its loads to fp32 and rounds dq, dk and dv to bf16 at
the store) in one of two configurations: Small, one launch that owns all
of a (batch, kv head)'s keys (the encoders' short sequences), or Large,
for long rows (a Delta launch, a dK/dV walk cut into balanced parts with
an ordered sum of their partials, a dQ launch). The bf16 forward keeps its
row maximum in log2 units (it computes exp2); it writes ``lse`` as (m +
log2 l) ln 2, the natural log-sum-exp the backward recomputes P in. A row
with no live key gave the mean of v, so its gradient is dO/T to every
value and nothing to q or k (its ``lse`` is -inf in both types; the
backward tells such rows by index). The reference has no backward kernel;
it trains through XLA's autodiff of its einsum attention, the function
this backward differentiates. Every configuration fixes its summation
order: a call repeats bitwise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

HEAD_DIMS = (32, 64, 128, 256)      # the head dims the kernels are built for
DTYPES = (torch.float32, torch.bfloat16)
MASKED = -1e30          # the oracle's fill for masked scores


def kernel_head_dim(d: int) -> int:
    """The built head dim an fp32 kernel runs head dim ``d`` on: the
    smallest of ``HEAD_DIMS`` not below it."""
    return next(x for x in HEAD_DIMS if x >= d)


def live_mask(s: int, t: int, *, causal: bool, window: int,
              device) -> torch.Tensor:
    """(S, T) bool: key j is live for query row i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return mask


def _scores(q, k, *, causal, window, softcap, scale):
    """The scaled, soft-capped scores (B,KV,G,S,T) in float32, masked ones
    at ``MASKED``; the mask (S,T); tanh(s/cap) under a cap, else None."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    qr = q.reshape(b, kvh, h // kvh, s, d).to(torch.float32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qr,
                          k.to(torch.float32)) * scale
    th = None
    if softcap:
        th = torch.tanh(scores / softcap)
        scores = softcap * th
    mask = live_mask(s, t, causal=causal, window=window, device=q.device)
    return torch.where(mask, scores, MASKED), mask, th


def _plain_forward(q, k, v, *, causal, window, softcap, scale, want_lse):
    """Dense masked softmax attention in float32, cast back to q's type
    (``attention_ref``'s arithmetic), and, when ``want_lse``, the row
    log-sum-exp (B,H,S) over the live keys (-inf on a row with none)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scores, mask, _ = _scores(q, k, causal=causal, window=window,
                              softcap=softcap, scale=scale)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    out = out.reshape(b, h, s, d).to(q.dtype)
    if not want_lse:
        return out, None
    lse = torch.logsumexp(torch.where(mask, scores, -torch.inf), dim=-1)
    return out, lse.reshape(b, h, s)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: float | None = None) -> torch.Tensor:
    """Dense masked softmax attention in float32, cast back to q's type
    (``attention_ref``'s arithmetic)."""
    return _plain_forward(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, want_lse=False)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    gradient ``do``, from the forward's output ``o`` and row log-sum-exp
    ``lse`` (B,H,S): P = exp(s - lse) on the live keys, dV = P^T dO,
    dS = P (dO V^T - rowsum(dO o)), times 1 - tanh^2(s/cap) under a cap,
    dQ = scale dS K, dK = scale dS^T Q (summed over a kv head's group). A
    row with no live key (its output is the mean of v) gives dO/T to every
    value and nothing to q or k. Float32 throughout, cast to the inputs'
    types."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    f32 = torch.float32
    scores, mask, th = _scores(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    p = torch.where(mask, torch.exp(scores - lse.to(f32).reshape(
        b, kvh, g, s, 1)), 0.0)
    dead = ~mask.any(dim=-1, keepdim=True)                    # (S, 1)
    p = torch.where(dead, 1.0 / t, p)
    qr = q.reshape(b, kvh, g, s, d).to(f32)
    dor = do.reshape(b, kvh, g, s, d).to(f32)
    delta = (dor * o.reshape(b, kvh, g, s, d).to(f32)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dor)
    dp = torch.einsum("bkgsd,bktd->bkgst", dor, v.to(f32))
    ds = torch.where(mask, p * (dp - delta), 0.0)
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qr) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _inner_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _outer_strides(x: torch.Tensor, tma: bool, axes: int = 3) -> list[int]:
    """The strides of the ``axes`` outer axes in elements (batch, head and
    sequence here). TMA reads the stride of a size-1 axis only through
    coordinate 0, so there it is given the last dim, which keeps the
    tensor map's 16-byte rule."""
    st = list(x.stride()[:axes])
    if tma:
        st = [s if n > 1 else x.shape[-1]
              for s, n in zip(st, x.shape[:axes])]
    return st


def _check_tma(name: str, x: torch.Tensor, axes: int = 3) -> None:
    """Raise unless TMA can load ``x``: a 16-byte aligned address and
    strides of its ``axes`` outer axes (those longer than 1) of a multiple
    of 16 bytes."""
    size = x.element_size()
    if x.data_ptr() % 16 or any(s * size % 16 for s, n in
                                zip(x.stride()[:axes], x.shape[:axes])
                                if n > 1):
        raise ValueError(
            f"bf16 {name} at address {x.data_ptr():#x} with strides "
            f"{tuple(x.stride())}: the bf16 kernel loads through TMA, which "
            f"needs a 16-byte aligned address and outer (batch, head, "
            f"sequence) strides of a multiple of 8 elements")


def _check_cuda(q, k, v, window) -> None:
    """Raise for what the CUDA kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    check_args(q, k, v, window)


def check_args(q, k, v, window) -> None:
    """Raise for the shapes, dtypes and windows the CUDA kernels do not
    take, on any device (``meta`` tensors too)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B,H,S,D), (B,KV,T,D) x2")
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} do "
                         f"not agree (H % KV == 0 needed)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want one "
                         f"of {DTYPES} for all three")
    if q.dtype == torch.bfloat16 and d not in HEAD_DIMS:
        raise ValueError(f"bf16 head dim {d} not in {HEAD_DIMS}")
    if not 1 <= d <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {d} not in [1, {HEAD_DIMS[-1]}]")
    if t < 1 or s < 1 or b > 65535 or h > 65535 or window < 0:
        raise ValueError(f"unsupported S {s}, T {t}, B {b}, H {h} or "
                         f"window {window}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _forward(q, k, v, *, causal, window, softcap, scale, want_lse):
    """(out, lse or None) by device: the plain version on the CPU, a kernel
    on the card (either kernel writes ``lse`` only when asked)."""
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              want_lse=want_lse)
    _check_cuda(q, k, v, window)
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    q, k, v = (_inner_contiguous(x) for x in (q, k, v))
    tma = q.dtype == torch.bfloat16
    if tma:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, x)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if want_lse else None)
    scale = d ** -0.5 if scale is None else scale
    lib = _build.library("flash_attention")
    P = _build.ptr
    strides = [ctypes.c_longlong(st) for x in (q, k, v, out)
               for st in _outer_strides(x, tma)]
    args = (P(q), P(k), P(v), P(out), b, h, kvh, s, t, d, *strides,
            float(scale), float(softcap), int(bool(causal)), int(window))
    launch = (lib.flash_attention_sm90_launch if tma
              else lib.flash_attention_launch)
    with torch.cuda.device(q.device):
        code = launch(*args, P(lse), _build.stream(q.device))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward keeps the row
    log-sum-exp, the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _forward(q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Attention (B,H,S,D) of q (B,H,S,D) over k, v (B,KV,T,D). CPU tensors
    take the plain version; CUDA tensors launch the fp32 or the bf16 kernel
    and count the launch in ``flash_attention.launches``. With grad mode on
    and an input that requires grad, it runs through ``FlashAttention``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale, want_lse=False)[0]


flash_attention.launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None):
    """The forward as training runs it: (out, lse), the row log-sum-exp
    (B,H,S) float32 that ``flash_attention_bwd`` recomputes P from. No
    graph is recorded; the kernel launch counts as ``flash_attention``'s."""
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale, want_lse=True)


# the backward's plans (csrc/flash_attention_bwd.cu runs Small and Large,
# csrc/flash_attention_bwd_sm90.cu the Hopper design)
BWD_SMALL, BWD_LARGE, BWD_SM90 = 0, 1, 2
BWD_SM90_HEAD_DIMS = (64, 128, 256)   # the bf16 head dims it takes
BWD_SM90_ROWS = 64                # its dK/dV pass's rows a step
BWD_SM90_QUERY_ROWS = 128         # its dQ pass's rows a block

# set from tools/bwd_variants.py --sweep (its timings are in PERF.md)
BWD_SMALL_MAX_STEPS = 16          # Small: the longest walk the sweep timed
BWD_SMALL_SHORT_WALK = 2          # Small on any grid: walks this short
BWD_SMALL_MIN_BLOCKS = 128        # else Small from this many blocks (B KV)
BWD_PART_STEPS = 16               # Large: the most steps a dK/dV part walks
BWD_PART_INTS = 8                 # int32 a row of the part table


def bwd_sm90_keys(d: int) -> int:
    """The Hopper design's dK/dV key tile at head dim ``d``: 128 keys, two
    warpgroups of 64; 64 at 256, whose warpgroups split the columns."""
    return 64 if d == 256 else 128


class BwdPlan(NamedTuple):
    """A ``flash_attention_bwd`` launch: ``cfg`` 0 Small, 1 Large, 2 the
    Hopper design (``BWD_SM90``); ``keys`` a dK/dV block's key tile and
    ``rows`` its query rows a step; Large cuts a key tile's walk into parts
    of at most ``steps_per_part`` (head, row tile) steps (the Hopper design
    walks each key tile in one part), ``parts`` dK/dV blocks per (batch, kv
    head) in all; ``launches`` kernels per call."""
    cfg: int
    keys: int
    rows: int
    steps_per_part: int
    parts: int
    launches: int


def bwd_small_keys(dp: int) -> int:
    """The most keys (T) the Small configuration takes at built head dim
    ``dp``: a (batch, kv head)'s K and V, a step's rows and P and dS in 227
    KB, and its dK/dV and dQ in registers."""
    return 64 if dp <= 128 else 32


def _walks(s: int, t: int, keys: int, rows: int, *, causal: bool,
           window: int, small: bool) -> list[tuple[int, int]]:
    """(first row tile, row tiles) each key tile of ``keys`` keys walks per
    head, in row tiles of ``rows`` rows: under Small every row tile; else
    those holding a live key for the tile."""
    out = []
    for jt in range(-(-t // keys)):
        if small:
            out.append((0, -(-s // rows)))
            continue
        j0, j_last = jt * keys, min(jt * keys + keys, t) - 1
        i_lo = j0 if causal else 0
        i_hi = min(s, j_last + window) if window > 0 else s
        t_lo = i_lo // rows
        out.append((t_lo, -(-i_hi // rows) - t_lo if i_hi > i_lo else 0))
    return out


def bwd_parts(s: int, t: int, group: int, plan: BwdPlan, *, causal: bool,
              window: int) -> list[tuple[int, ...]]:
    """The plan's part table, which the kernels read: a row per dK/dV block
    of a (batch, kv head), in launch order, of (key tile, first row tile,
    row tiles, first step, end step, the key tile's first part, its parts).
    Step n of a key tile's walk is head n // (row tiles) of the kv head's
    group at row tile first + n % (row tiles). Small walks every row tile
    of its one key tile in one part; Large only the row tiles holding a
    live key for the tile, a walk of L steps cut into max(1, ceil(L /
    steps_per_part)) parts of floor-divided lengths; the Hopper design as
    Large, in one part a key tile."""
    out = []
    for jt, (t_lo, n_rows) in enumerate(_walks(
            s, t, plan.keys, plan.rows, causal=causal, window=window,
            small=plan.cfg == BWD_SMALL)):
        n = group * n_rows
        cuts = 1 if plan.cfg == BWD_SMALL or n <= plan.steps_per_part else \
            -(-n // plan.steps_per_part)
        first = len(out)
        out += [(jt, t_lo, n_rows, q * n // cuts, (q + 1) * n // cuts, first,
                 cuts) for q in range(cuts)]
    return out


def bwd_plan(b: int, h: int, kv: int, s: int, t: int, d: int, causal: bool,
             window: int, dtype: torch.dtype = torch.float32,
             cfg: int | None = None,
             steps_per_part: int | None = None) -> BwdPlan:
    """The ``flash_attention_bwd`` launch on the card for q (b,h,s,d) over
    k, v (b,kv,t,d) of ``dtype``. bf16 at head dims 64, 128 and 256
    (``BWD_SM90_HEAD_DIMS``) takes the Hopper design (``BWD_SM90``: a dQ
    pass, then a dK/dV pass whose blocks each walk one key tile of
    ``bwd_sm90_keys(d)`` keys in one part, in steps of ``BWD_SM90_ROWS``
    rows); fp32, and bf16 at head dim 32, the SIMT kernels. Among those,
    Small's one block per (batch, kv head) walks the group's heads times
    the row tiles in series; it is taken where T fits its key tile
    (``bwd_small_keys``), the walk is at most ``BWD_SMALL_MAX_STEPS``
    steps, and either Large would pad (Small's key tile is the smaller:
    T <= 32 below head dim 256), the walk is at most
    ``BWD_SMALL_SHORT_WALK`` steps, or Small's blocks (b kv) number at
    least ``BWD_SMALL_MIN_BLOCKS``, about one an SM. Large otherwise, each
    key tile's walk cut into parts of at most ``BWD_PART_STEPS`` steps.
    ``cfg`` names the configuration instead and ``steps_per_part`` Large's
    part length (tests and sweeps force them this way); ValueError where
    they cannot run."""
    dp = kernel_head_dim(d)
    group = h // kv
    if cfg not in (None, BWD_SMALL, BWD_LARGE, BWD_SM90):
        raise ValueError(f"flash_attention_bwd: no configuration {cfg}")
    sm90 = dtype == torch.bfloat16 and d in BWD_SM90_HEAD_DIMS
    if cfg == BWD_SM90 and not sm90:
        raise ValueError(f"flash_attention_bwd: no configuration {cfg} for "
                         f"{dtype} at head dim {d}: the Hopper design takes "
                         f"bf16 at head dims {BWD_SM90_HEAD_DIMS}")
    if cfg == BWD_SM90 or (cfg is None and sm90):
        if steps_per_part is not None:
            raise ValueError("flash_attention_bwd: the Hopper design walks "
                             "each key tile in one part")
        keys = bwd_sm90_keys(d)
        walks = _walks(s, t, keys, BWD_SM90_ROWS, causal=causal,
                       window=window, small=False)
        return BwdPlan(BWD_SM90, keys, BWD_SM90_ROWS,
                       max(1, group * max(n for _, n in walks)), len(walks),
                       2)
    fits = t <= bwd_small_keys(dp)
    if cfg == BWD_SMALL and not fits:
        raise ValueError(f"flash_attention_bwd: Small takes at most "
                         f"{bwd_small_keys(dp)} keys at head dim {d}, not "
                         f"T {t}")
    small_keys = 32 if t <= 32 else 64
    kp = 64 if dp <= 128 else 32              # Large's key tile
    if cfg is None:
        steps = group * -(-s // small_keys)
        cfg = BWD_SMALL if fits and steps <= BWD_SMALL_MAX_STEPS and (
            small_keys < kp or steps <= BWD_SMALL_SHORT_WALK
            or b * kv >= BWD_SMALL_MIN_BLOCKS) else BWD_LARGE
    if cfg == BWD_SMALL:
        if steps_per_part is not None:
            raise ValueError("flash_attention_bwd: Small walks in one part")
        return BwdPlan(BWD_SMALL, small_keys, small_keys,
                       group * -(-s // small_keys), 1, 1)
    if steps_per_part is not None and steps_per_part < 1:
        raise ValueError(f"flash_attention_bwd: {steps_per_part} steps a "
                         f"part")
    walks = _walks(s, t, kp, kp, causal=causal, window=window, small=False)
    plan = BwdPlan(BWD_LARGE, kp, kp, steps_per_part or BWD_PART_STEPS, 0,
                   0)
    parts = len(bwd_parts(s, t, group, plan, causal=causal, window=window))
    return plan._replace(parts=parts,
                         launches=3 + int(parts > len(walks)))


@functools.lru_cache(maxsize=64)
def _part_table(s: int, t: int, group: int, plan: BwdPlan, causal: bool,
                window: int, device: torch.device) -> torch.Tensor:
    """``bwd_parts`` as the kernels read it: (parts, ``BWD_PART_INTS``)
    int32 on ``device``, made once per shape and plan."""
    rows = [r + (0,) * (BWD_PART_INTS - len(r))
            for r in bwd_parts(s, t, group, plan, causal=causal,
                               window=window)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention`` (see
    ``flash_attention_bwd_plain``). CPU tensors take the plain version;
    CUDA tensors launch the configuration ``bwd_plan`` picks and count the
    call in ``flash_attention_bwd.launches``; every tensor is read and
    written through its batch, head and sequence strides. bf16 at head
    dims 64, 128 and 256: ``csrc/flash_attention_bwd_sm90.cu`` (the Hopper
    design: a dQ pass that also writes the rows' lse and rowsum(dO o), then
    the dK/dV pass; wgmma on the tensor cores, TMA loads, so q, k, v, o and
    dO must meet ``_check_tma``'s rule, else ``ValueError``; P and dS
    rounded to bf16 before their products, as the reference's bf16 autodiff
    rounds them). fp32, and bf16 at head dim 32:
    ``csrc/flash_attention_bwd.cu`` (Small: one kernel; Large: the row sums
    rowsum(dO o), the dK/dV parts, their ordered sum where a key tile's walk
    was cut, dQ), fp32 arithmetic on the CUDA cores, bf16 loads widened to
    fp32 and dq, dk and dv rounded to bf16 at the store."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    _check_cuda(q, k, v, window)
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}: want q's shape, dtype and device")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"({b}, {h}, {s}) float32")
    causal, window = bool(causal), int(window)
    plan = bwd_plan(b, h, kvh, s, t, d, causal, window, q.dtype)
    table = _part_table(s, t, h // kvh, plan, causal, window, q.device)
    q, k, v, o, do = (_inner_contiguous(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scale = d ** -0.5 if scale is None else scale
    P = _build.ptr
    sm90 = plan.cfg == BWD_SM90
    strides = [ctypes.c_longlong(st) for x in (q, k, v, o, do, dq, dk, dv)
               for st in _outer_strides(x, sm90)]
    if sm90:
        for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            _check_tma(name, x)
        s_pad = -(-s // BWD_SM90_QUERY_ROWS) * BWD_SM90_QUERY_ROWS
        stats = torch.empty((2, b * h, s_pad), dtype=torch.float32,
                            device=q.device)
        lib = _build.library("flash_attention_bwd_sm90")
        with torch.cuda.device(q.device):
            code = lib.flash_attention_bwd_sm90_launch(
                P(q), P(k), P(v), P(o), P(lse), P(do), P(dq), P(dk), P(dv),
                P(stats), P(table), b, h, kvh, s, t, d, *strides,
                float(scale), float(softcap), int(causal), window,
                plan.parts, _build.stream(q.device))
        _build.check(code, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
        return dq, dk, dv
    delta = part = None
    if plan.cfg == BWD_LARGE:
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if plan.launches == 4:
            part = torch.empty((plan.parts * kvh * b * 2 * plan.keys *
                                kernel_head_dim(d),), dtype=torch.float32,
                               device=q.device)
    lib = _build.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_launch(
            P(q), P(k), P(v), P(o), P(lse), P(do), P(dq), P(dk), P(dv),
            P(delta), P(part), P(table), b, h, kvh, s, t, d, *strides,
            float(scale), float(softcap), int(causal), window, plan.cfg,
            plan.keys, plan.parts, int(q.dtype == torch.bfloat16),
            _build.stream(q.device))
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
