"""Stochastic Gradient Langevin Dynamics (Welling & Teh 2011); counterpart
of ``repro/optim/sgld.py``.

theta' = theta - (eps/2) * grad U(theta) + sqrt(eps) * N(0, I)
"""
from __future__ import annotations

import math

import torch


def decayed_step_size(eps0: float, t, t0: float, power: float):
    """eps0 * (t0/(t0+t))^power; power 0 keeps steps constant."""
    return eps0 * (t0 / (t0 + t)) ** power


def sgld_step(theta, grad_u, eps, draws):
    """One SGLD step on a tensor, a list of tensors or a dict of tensors
    (leaves in sorted-key order, as ``jax.tree.flatten`` orders a dict);
    leaf i takes its noise from the i-th source of ``draws.split``."""
    if isinstance(theta, torch.Tensor):
        keys, leaves, grads = None, [theta], [grad_u]
    elif isinstance(theta, dict):
        keys = sorted(theta)
        leaves = [theta[k] for k in keys]
        grads = [grad_u[k] for k in keys]
    else:
        keys, leaves, grads = None, list(theta), list(grad_u)
    root = eps ** 0.5 if isinstance(eps, torch.Tensor) else math.sqrt(eps)
    new = [t - 0.5 * eps * g + root * s.normal(tuple(t.shape), t.device)
           for t, g, s in zip(leaves, grads, draws.split(len(leaves)))]
    if isinstance(theta, torch.Tensor):
        return new[0]
    if keys is not None:
        return dict(zip(keys, new))
    return new
