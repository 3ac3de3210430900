"""Contrastive training of the embedding encoder (counterpart of
``repro/contrastive/finetune.py``).

Two stages, as in the paper's setup:

* ``pretrain_generic``: the stand-in for a general-purpose pretrained
  sentence encoder, cosine-similarity regression against token-overlap
  (Jaccard) targets;
* ``finetune_categorical``: the paper's CCFT fine-tuning step, pairs
  labelled 1 (same category) or 0 (different), regressed by cosine
  similarity (the sentence-transformers CosineSimilarityLoss recipe).

Every draw goes through a draw source (``core/draws.py``) passed where the
reference passes a key: ``split(2)`` where it splits, ``randint`` for its
``jax.random.randint`` and ``choice`` for its weighted
``jax.random.choice``. ``train_step`` takes the gradient of the loss by
autograd with respect to the parameter leaves themselves (the stacked
``units`` included: ``encode`` slices them per layer, and the slices'
gradients sum into the stacked leaf); on the card every attention runs
the flash kernel forward and its backward kernel. The losses accumulate
on the device: one host sync per epoch (per run for ``pretrain_generic``).
"""
from __future__ import annotations

import torch

from repro_torch.device import as_f32
from repro_torch.encoder.model import EncoderConfig, encode
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import adamw_init, adamw_update


def _pair_cosine(params, toks_a, mask_a, toks_b, mask_b, cfg):
    ea = encode(params, toks_a, mask_a, cfg)
    eb = encode(params, toks_b, mask_b, cfg)
    return torch.sum(ea * eb, dim=-1)


def cosine_loss(params, batch, cfg: EncoderConfig) -> torch.Tensor:
    """Mean squared error of the pairs' cosine similarity against their
    targets (the mean as the sum times 1/n, as ``jnp.mean`` rounds)."""
    sim = _pair_cosine(params, batch["tok_a"], batch["mask_a"],
                       batch["tok_b"], batch["mask_b"], cfg)
    err = sim - batch["target"]
    return torch.sum(err * err) * (1.0 / err.numel())


def loss_and_grads(params, batch, cfg: EncoderConfig):
    """(the cosine loss as a 0-d tensor, its gradient tree), by autograd
    with respect to the parameter leaves themselves (``jax.value_and_grad``
    of ``cosine_loss``)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = cosine_loss(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def train_step(params, opt_state, batch, cfg: EncoderConfig,
               lr: float = 2e-3):
    """One AdamW step (weight decay 0.01) on the cosine loss. Returns (new
    params, new optimizer state, the loss as a 0-d tensor on the device)."""
    loss, grads = loss_and_grads(params, batch, cfg)
    with torch.no_grad():
        params, opt_state = adamw_update(params, grads, opt_state, lr,
                                         weight_decay=0.01)
    return params, opt_state, loss


@torch.no_grad()
def category_silhouette(params, cfg: EncoderConfig, tokens, mask,
                        cats) -> float:
    """Mean cosine similarity of same-category query pairs minus that of
    different-category pairs (each unordered pair once): the separation
    fine-tuning should raise (``examples/train_encoder_e2e.py``'s
    measure)."""
    emb = encode(params, tokens, mask, cfg)
    sim = emb @ emb.T
    c = cats.to(sim.device)
    upper = torch.triu(torch.ones_like(sim, dtype=torch.bool), diagonal=1)
    same = (c[:, None] == c[None, :]) & upper
    diff = (c[:, None] != c[None, :]) & upper
    return float(sim[same].mean() - sim[diff].mean())


def jaccard_targets(tok_a: torch.Tensor, tok_b: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """Token-overlap similarity in [0, 1]: the generic pretraining target."""
    def onehot(tok):
        out = torch.zeros((tok.shape[0], vocab), dtype=torch.float32,
                          device=tok.device)
        return out.scatter_(1, tok.long(), 1.0)
    oa, ob = onehot(tok_a), onehot(tok_b)
    inter = torch.sum(oa * ob, dim=-1)
    union = torch.clamp_min(torch.sum(torch.maximum(oa, ob), dim=-1), 1.0)
    return inter / union


def _distinct_partner(draws, ia: torch.Tensor, n: int) -> torch.Tensor:
    """A uniform partner index != ia: a shift by 1..n-1 (mod n), so no row
    pairs with itself (a trivial target-1 pair)."""
    off = draws.randint(tuple(ia.shape), 0, max(n - 1, 1), ia.device)
    return (ia + 1 + off) % n


def _pairs(ia, ib, tokens, mask, target) -> dict:
    return {"tok_a": tokens[ia], "mask_a": mask[ia],
            "tok_b": tokens[ib], "mask_b": mask[ib], "target": target}


def make_category_pairs(draws, tokens, mask, cats, batch: int,
                        row_weights=None) -> dict:
    """Pairs labelled by category equality (the paper's pair construction).

    ``row_weights`` (optional, (n,) nonnegative) biases the anchor draw;
    partners stay uniform over the other rows."""
    k1, k2 = draws.split(2)
    n, dev = tokens.shape[0], tokens.device
    if row_weights is None:
        ia = k1.randint((batch,), 0, n, dev)
    else:
        p = torch.clamp_min(as_f32(row_weights, dev), 0.0) + 1e-9
        ia = k1.choice(n, (batch,), p / p.sum(), dev)
    ib = _distinct_partner(k2, ia, n)
    target = (cats[ia] == cats[ib]).to(torch.float32)
    return _pairs(ia, ib, tokens, mask, target)


def make_generic_pairs(draws, tokens, mask, vocab: int, batch: int) -> dict:
    """Uniform distinct pairs with Jaccard targets."""
    k1, k2 = draws.split(2)
    n = tokens.shape[0]
    ia = k1.randint((batch,), 0, n, tokens.device)
    ib = _distinct_partner(k2, ia, n)
    target = jaccard_targets(tokens[ia], tokens[ib], vocab)
    return _pairs(ia, ib, tokens, mask, target)


def pretrain_generic(draws, params, tokens, mask, cfg: EncoderConfig,
                     steps: int = 200, batch: int = 64, lr: float = 2e-3):
    """``steps`` steps on generic pairs. Returns (params, [mean loss])."""
    opt = adamw_init(params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for _ in range(steps):
        draws, kb = draws.split(2)
        b = make_generic_pairs(kb, tokens, mask, cfg.vocab_size, batch)
        params, opt, loss = train_step(params, opt, b, cfg, lr)
        loss_sum = loss_sum + loss
    return params, [float(loss_sum) / max(steps, 1)]


def finetune_categorical(draws, params, tokens, mask, cats,
                         cfg: EncoderConfig, epochs: int = 4,
                         steps_per_epoch: int = 50, batch: int = 64,
                         lr: float = 1e-3, row_weights=None):
    """The paper's fine-tuning: ``epochs`` x ``steps_per_epoch`` steps on
    category pairs (a fresh optimizer state). Returns (params, the mean
    loss of each epoch)."""
    opt = adamw_init(params)
    losses = []
    for _ in range(epochs):
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for _ in range(steps_per_epoch):
            draws, kb = draws.split(2)
            b = make_category_pairs(kb, tokens, mask, cats, batch,
                                    row_weights=row_weights)
            params, opt, loss = train_step(params, opt, b, cfg, lr)
            loss_sum = loss_sum + loss
        losses.append(float(loss_sum) / max(steps_per_epoch, 1))
    return params, losses
