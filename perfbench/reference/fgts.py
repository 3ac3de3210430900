"""Plain PyTorch reference of the router's policy (FGTS.CDB): the SGLD
refresh of both samples' chains, the cost-tilted pair selection and the
fold of resolved duels into the replay ring. Written out from the paper's
Algorithm 1 and the port's stated semantics; it imports nothing of the
program.

The draws are the service's: a ``KeyedDraws`` source positioned by a
(2,) uint32 key, whose children come from a fixed 64-bit hash and whose
numbers come from a device generator seeded from that hash. That
arithmetic is copied here (``Key``), so the reference draws the same
minibatch indices and Langevin noise from the service's seed.
"""
from __future__ import annotations

import torch

from .dense import rounded

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class Key:
    """A draw key: ``split``, ``fold_in`` and device draws."""

    def __init__(self, word: int):
        self.word = word & _M64

    @classmethod
    def from_seed(cls, seed: int) -> "Key":
        return cls(int(seed) & _M64)

    def split(self, n: int) -> list:
        base = _mix64(self.word)
        return [Key(_mix64(base + i + 1)) for i in range(n)]

    def fold_in(self, i: int) -> "Key":
        return Key(_mix64(_mix64(self.word) ^ _mix64(
            0xF01D0000_00000000 | (int(i) & 0xFFFFFFFF))))

    def draw(self, kind: str, shape, device) -> torch.Tensor:
        g = torch.Generator(device=device)
        g.manual_seed(_mix64(self.word ^ 0x5EED5EED5EED5EED))
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        return out.normal_(generator=g) if kind == "normal" \
            else out.uniform_(generator=g)


def service_key(seed: int, call: int) -> Key:
    """The key a service seeded ``seed`` hands its ``call``-th draw
    (call 0: the policy's init, then one per route)."""
    src = Key.from_seed(seed)
    for _ in range(call + 1):
        src, k = src.split(2)
    return k


def init_chains(key: Key, c: int, d: int, prior_var: float, device):
    """The chains the policy starts from (theta1, theta2), (C, d) each."""
    _, k1, k2 = key.split(3)
    s = prior_var ** 0.5
    return (k1.draw("normal", (c, d), device) * s,
            k2.draw("normal", (c, d), device) * s)


def scores(x, a, theta, mode: str = "fp32"):
    """<theta, phi(x, a_k)>: x (..., m, d), theta (..., d) -> (..., m, K),
    with phi(x, a) = x * a / ||x * a||; ``mode``: the products' operands
    (``dense.rounded``)."""
    r = lambda t: rounded(t, mode)
    num = r(x * theta[..., None, :]) @ r(a.T)
    den = torch.sqrt(torch.clamp_min(r(x * x) @ r((a * a).T), 1e-24))
    return num / den


def _softplus(v):
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-torch.abs(v)))


def potential(theta, idx, ring: dict, a, costs, j: int, cfg: dict,
              mode: str = "fp32"):
    """U(theta_c) over the minibatch ring rows idx (C, m) for sample j:
    (T / n_valid) sum of the per-duel losses plus the Gaussian prior."""
    t = ring["t"].to(torch.float32)
    valid = (idx < ring["t"]).to(torch.float32)
    scale = t / torch.clamp_min(valid.sum(-1), 1.0)
    i = idx.long()
    x, a1, a2, y, pref = (ring["x"][i], ring["a1"][i].long(),
                          ring["a2"][i].long(), ring["y"][i], ring["pref"][i])
    s = scores(x, a, theta, mode)                             # (C, m, K)
    s1 = torch.gather(s, -1, a1[..., None])[..., 0]
    s2 = torch.gather(s, -1, a2[..., None])[..., 0]
    ll = cfg["eta"] * _softplus(-(y * (s1 - s2)))
    tilt = pref[..., None] * costs
    opp = a2 if j == 1 else a1
    s_opp = (s2 if j == 1 else s1) - torch.gather(tilt, -1,
                                                 opp[..., None])[..., 0]
    feelgood = (s - tilt).amax(-1) - s_opp
    mu = cfg["mu"] / (1.0 + torch.clamp_min(pref, 0.0))
    data = torch.sum((ll - mu * feelgood) * valid, dim=-1)
    return scale * data + (theta * theta).sum(-1) / (2.0 * cfg["prior_var"])


def refresh(key: Key, th1, th2, ring: dict, a, costs, cfg: dict,
            mode: str = "fp32"):
    """Both samples' SGLD chains after ``cfg["sgld_steps"]`` steps."""
    cap = ring["x"].shape[0]
    hi = torch.clamp_min(torch.clamp_max(ring["t"], cap), 1)
    eps = torch.tensor(cfg["sgld_eps"], dtype=torch.float32)
    noise_scale = torch.sqrt(eps * cfg["sgld_temp"]).to(a.device)
    out = []
    for j, (kj, th) in enumerate(zip(key.split(2), (th1, th2)), start=1):
        c, d = th.shape
        for i in range(cfg["sgld_steps"]):
            k_idx, k_noise = kj.fold_in(i).split(2)
            u = k_idx.draw("uniform", (c, cfg["sgld_minibatch"]), a.device)
            idx = torch.minimum(torch.floor(u * hi).to(torch.int64),
                                (hi - 1).to(torch.int64))
            noise = k_noise.draw("normal", (c, d), a.device)
            with torch.enable_grad():
                v = th.detach().requires_grad_(True)
                g = torch.autograd.grad(
                    potential(v, idx, ring, a, costs, j, cfg, mode).sum(),
                    v)[0]
            th = th - 0.5 * eps.to(a.device) * g + noise_scale * noise
        out.append(th.detach())
    return out


def select(x, a, th1, th2, tilt, mode: str = "fp32"):
    """Tilted scores of both samples (2, B, K) from the chain means, and
    the pair: the first argmax of each."""
    s = torch.stack([scores(x, a, th1.mean(0), mode),
                     scores(x, a, th2.mean(0), mode)])
    s = s - tilt
    return s, s[0].argmax(-1).to(torch.int32), s[1].argmax(-1).to(torch.int32)


def fold(ring: dict, x, a1, a2, y) -> dict:
    """Append n resolved duels to the ring in order (slot (t + i) mod H;
    the last H survive), their pref 0; t advances by n."""
    cap, n = ring["x"].shape[0], x.shape[0]
    out = {k: v.clone() for k, v in ring.items()}
    drop = max(0, n - cap)
    idx = ((ring["t"].long() + drop + torch.arange(n - drop,
                                                   device=x.device)) % cap)
    out["x"][idx] = x[drop:]
    out["a1"][idx] = a1[drop:].to(out["a1"].dtype)
    out["a2"][idx] = a2[drop:].to(out["a2"].dtype)
    out["y"][idx] = y[drop:].to(out["y"].dtype)
    out["pref"][idx] = 0.0
    out["t"] = ring["t"] + n
    return out
