"""Cumulative dueling regret (paper eq. 1) and convergence diagnostics
(counterpart of ``repro/core/regret.py``)."""
from __future__ import annotations

import numpy as np
import torch


def instant_regret(utils_t: torch.Tensor, a1, a2, active=None):
    """max_k u_k - (u_a1 + u_a2)/2 over utilities (..., K) and arms (...).

    ``active`` (K,) bool restricts the comparator to the available arms; an
    all-inactive mask gives -inf (a caller bug, as in the reference)."""
    u = utils_t if active is None else torch.where(active, utils_t, -torch.inf)
    best = u.amax(dim=-1)
    a1 = torch.as_tensor(a1, device=utils_t.device).long()
    a2 = torch.as_tensor(a2, device=utils_t.device).long()
    pick = lambda i: torch.gather(utils_t, -1, i[..., None])[..., 0]
    return best - 0.5 * (pick(a1) + pick(a2))


def slope_ratio(cum_regret, frac: float = 0.2) -> float:
    """Late-window slope / early-window slope — < 1 means converging; the
    window is clamped to the curve, a single point gives 1.0."""
    if isinstance(cum_regret, torch.Tensor):
        cum_regret = cum_regret.detach().cpu().numpy()
    cum = np.asarray(cum_regret)
    t = len(cum)
    if t < 2:
        return 1.0
    w = min(max(int(t * frac), 2), t - 1)
    early = (cum[w] - cum[0]) / w
    late = (cum[-1] - cum[-1 - w]) / w
    return float(late / max(early, 1e-9))
