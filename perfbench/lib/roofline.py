"""Operations and bytes of the logical operations the cells run, counted
from their shapes (each input read once, each output written once), and
the least time the chip could take for them. The formulas for the kernels
are those the port's ``chip_smoke.py`` and ``launch/router_dryrun.py``
use (attention: 4 D operations a live pair; the SGLD gradient's and the
selection's bytes), frozen here.
"""
from __future__ import annotations


def bound_s(flops: float, nbytes: float, peak_flops: float,
            bw: float) -> float:
    """Seconds at the roofline: the larger of operations over the peak and
    bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / bw)


def attention(b, h, kv, s, t, d, causal: bool, el: int) -> tuple:
    """(flops, bytes) of one attention call: q (b,h,s,d), k / v
    (b,kv,t,d), output like q; causal self-attention has s (s + 1) / 2
    live pairs a head (s == t), bidirectional s t."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * t)
    return 4.0 * d * pairs, el * (2 * b * h * s * d + 2 * b * kv * t * d)


def sgld_grad_call(c, m, k, d) -> tuple:
    """(flops, bytes) of one SGLD potential-gradient call: C chains over
    a minibatch of m ring rows (x, a1, a2, y, pref, index, valid), K arms
    of width d."""
    flops = 4.0 * c * m * k * d + 7.0 * c * m * d
    nbytes = c * m * (4 * d + 4 * 4 + 8 + 4) + 4 * k * d + 5 * k + 4 * c \
        + 8 * c * d
    return flops, nbytes


def select(b, k, d) -> tuple:
    """(flops, bytes) of one pair selection over b rows, K arms."""
    return 6.0 * b * k * d, 4 * (b * d + k * d + 2 * d + 2 * b) + 5 * k


def layer_matmul_flops(d, h, kv, hd, ff) -> float:
    """Operations a token of one attention + gated-MLP block spends in its
    projections: q, k, v, o and the three MLP matrices."""
    return 2.0 * d * (h * hd + 2 * kv * hd) + 2.0 * h * hd * d + 6.0 * d * ff


def encoder_query_flops(seq, d, h, hd, ff, layers) -> float:
    """One query through the bidirectional encoder: every one of its
    ``seq`` positions (padding included, as the encoder attends over it)
    in every layer, attention over all ``seq`` keys."""
    per_token = layer_matmul_flops(d, h, h, hd, ff) + 4.0 * h * hd * seq
    return per_token * seq * layers


def lm_prompt_flops(length: int, d, h, kv, hd, ff, layers, vocab) -> float:
    """A prompt of ``length`` tokens through a causal dense LM (token p
    attends to p + 1 keys) and the head on its last position."""
    pairs = length * (length + 1) / 2
    return layers * (layer_matmul_flops(d, h, kv, hd, ff) * length
                     + 4.0 * h * hd * pairs) + 2.0 * d * vocab


def lm_weight_elems(d, h, kv, hd, ff, layers, vocab) -> int:
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff + 2 * d
    return vocab * d + layers * per_layer + d


def lm_decode_step(b, pos, d, h, kv, hd, ff, layers, vocab, el) -> tuple:
    """(flops, bytes) of one decode step of b rows at position ``pos``:
    every weight read once (the tied head among them), the live cache
    (positions 0..pos) of every layer read once, the step's K / V written,
    the float32 logits written."""
    flops = b * (layers * (layer_matmul_flops(d, h, kv, hd, ff)
                           + 4.0 * h * hd * (pos + 1)) + 2.0 * d * vocab)
    cache = layers * 2 * b * kv * hd * el
    nbytes = (el * lm_weight_elems(d, h, kv, hd, ff, layers, vocab)
              + cache * (pos + 1) + cache + 4 * b * vocab + 8 * b)
    return flops, nbytes
