"""Pool autopilot: closed-loop population management over a ``ModelPool``
(counterpart of ``repro/autopilot/controller.py``).

Three coupled loops, all tensor math inside the wrapped policy's own
``act``/``update``:

* **Auto-retirement by posterior dominance.** Every ``every`` acts the
  controller estimates P[theta . (e_i - e_j) > 0] over the posterior
  samples (``dominance.dominance_matrix``) and retires arm j once some
  cheaper-or-equal active full member dominates it with probability >= tau
  for ``window`` consecutive control ticks.
* **A/B candidate slots.** Arms that appear in the pool enter as
  candidates: a per-row Bernoulli(quota) gate, layered onto the active mask
  through ``RoutingPolicy.act_masked``, caps their traffic. A candidate is
  promoted after ``promote_wins`` resolved duel wins, or rolled back after
  ``max_cand_duels`` resolved duels without promotion.
* **Cost governor.** An EMA of the realized duel cost per act drives an
  integral lambda that tilts every score by lambda * cost_k.

The reference runs the control tick under ``lax.cond``. Here ``step``
runs on every act and ``torch.where`` on ``tick % every == 0`` keeps its
result or the unchanged controller and pool: the same values, with no host
sync on the tick count (one ``dueling_score`` launch per act).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import model_pool as mp
from repro_torch.core.policy import RoutingPolicy

from .dominance import dominance_matrix, dominated_by_cheaper


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    # -- control cadence ----------------------------------------------------
    every: int = 8             # acts between control ticks
    # -- posterior-dominance auto-retirement --------------------------------
    tau: float = 0.95          # dominance probability threshold
    window: int = 3            # consecutive dominated control ticks to retire
    min_active: int = 1        # hard floor on pool size (guards all kills)
    # -- A/B candidate slots ------------------------------------------------
    quota: float = 0.25        # candidate traffic share (per-row gate prob)
    promote_wins: float = 16.0     # resolved duel wins to promote
    max_cand_duels: float = 64.0   # resolved duels before auto-rollback
    candidates_on_arrival: bool = True  # new arms enter as candidates
    # -- cost governor ------------------------------------------------------
    budget: Optional[float] = None  # mean realized duel cost target; None=off
    budget_lr: float = 0.5          # integral gain on the budget error
    lam_max: float = 10.0           # lambda clamp
    cost_alpha: float = 0.1         # realized-cost EMA weight per act


class ControllerState(NamedTuple):
    """Autopilot bookkeeping, (K_max,)-shaped, riding next to the policy
    state."""
    known: torch.Tensor            # (K,) bool: membership snapshot (arrivals)
    candidate: torch.Tensor        # (K,) bool: arm is in A/B evaluation
    cand_wins: torch.Tensor        # (K,) f32: resolved duel wins as candidate
    cand_duels: torch.Tensor       # (K,) f32: resolved duels as candidate
    dominated_ticks: torch.Tensor  # (K,) i32: consecutive dominated ticks
    lam: torch.Tensor              # ()   f32: cost-governor tilt
    cost_ema: torch.Tensor         # ()   f32: realized mean duel cost EMA
    tick: torch.Tensor             # ()   i32: acts seen


class Decisions(NamedTuple):
    """One control tick's verdicts."""
    retire: torch.Tensor      # (K,) bool: dominated long enough: mask off
    promote: torch.Tensor     # (K,) bool: candidate -> full member
    rollback: torch.Tensor    # (K,) bool: candidate auto-retired
    dominated: torch.Tensor   # (K,) bool: dominated this tick (pre-window)
    lam: torch.Tensor         # ()   f32: cost-governor lambda after update


def init_controller(active0: torch.Tensor) -> ControllerState:
    """Fresh controller over an initial membership mask: the initial arms
    are full members (candidacy is for arrivals)."""
    k, dev = active0.shape[0], active0.device
    z = lambda *s, dt: torch.zeros(s, dtype=dt, device=dev)
    return ControllerState(
        known=active0.to(torch.bool).clone(),
        candidate=z(k, dt=torch.bool),
        cand_wins=z(k, dt=torch.float32),
        cand_duels=z(k, dt=torch.float32),
        dominated_ticks=z(k, dt=torch.int32),
        lam=z(dt=torch.float32),
        cost_ema=z(dt=torch.float32),
        tick=z(dt=torch.int32),
    )


def step(ctrl: ControllerState, posterior: torch.Tensor | None,
         pool: mp.ModelPool, cfg: AutopilotConfig, *,
         use_kernel: bool = True):
    """One control transition: (ctrl, posterior (S, d) or None, pool) ->
    (ctrl', decisions). None disables dominance (quota and budget still
    run); ``use_kernel=False`` scores the posterior with the plain
    version."""
    full = pool.active & ~ctrl.candidate           # voting/retirable members
    if posterior is None:
        dominated = torch.zeros_like(pool.active)
    else:
        dom = dominance_matrix(posterior, pool, use_kernel=use_kernel)
        dominated = dominated_by_cheaper(dom, pool.costs, full, full,
                                         cfg.tau)
    ticks = torch.where(dominated, ctrl.dominated_ticks + 1, 0)
    retire = full & (ticks >= cfg.window)

    cand = ctrl.candidate & pool.active
    promote = cand & (ctrl.cand_wins >= cfg.promote_wins)
    rollback = cand & ~promote & (ctrl.cand_duels >= cfg.max_cand_duels)

    # pool-size floor: cancel every kill this tick rather than choose
    # which to spare (the next tick retries)
    kill = retire | rollback
    ok = (pool.active & ~kill).sum(dtype=torch.int32) >= cfg.min_active
    retire = retire & ok
    rollback = rollback & ok

    lam = ctrl.lam
    if cfg.budget is not None:
        lam = torch.clamp(lam + cfg.budget_lr * (ctrl.cost_ema - cfg.budget),
                          0.0, cfg.lam_max)

    done = promote | rollback
    ctrl = ctrl._replace(
        candidate=ctrl.candidate & ~done,
        cand_wins=torch.where(done, 0.0, ctrl.cand_wins),
        cand_duels=torch.where(done, 0.0, ctrl.cand_duels),
        dominated_ticks=ticks,
        lam=lam,
    )
    return ctrl, Decisions(retire=retire, promote=promote, rollback=rollback,
                           dominated=dominated, lam=lam)


def apply_decisions(pool: mp.ModelPool, dec: Decisions) -> mp.ModelPool:
    """Fold a control tick's kills into the pool: a batched retirement."""
    kill = dec.retire | dec.rollback
    return pool._replace(active=pool.active & ~kill,
                         generation=pool.generation
                         + kill.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# The policy wrapper
# ---------------------------------------------------------------------------

class AutopilotState(NamedTuple):
    """Wrapped policy state: ``inner`` is the pool-backed policy's own
    ``PooledState`` (``model_pool.get_pool`` descends through it), ``ctrl``
    the controller bookkeeping."""
    inner: Any
    ctrl: ControllerState


def _fgts_posterior(state) -> torch.Tensor:
    """(2C, d) posterior samples: both FGTS thetas' warm-started chains."""
    return torch.cat([state.inner.theta1, state.inner.theta2], dim=0)


# policy.name -> posterior extractor over the inner (pooled) state; None
# (or a missing name) runs without the dominance loop. A point estimate
# (eps-greedy's MAP theta) is deliberately None: one sample makes
# win_matrix a sign test that can retire the pool before learning starts.
POSTERIOR_FNS: dict = {
    "fgts_cdb": _fgts_posterior,
    "vanilla_ts": _fgts_posterior,
    "eps_greedy": None,
    "uniform": None,
    "best_fixed": None,
    "linucb_duel": None,
}


def _pick(on: torch.Tensor, new, old):
    """Field by field ``torch.where(on, new, old)`` of two NamedTuples."""
    return type(old)(*(torch.where(on, a, b) for a, b in zip(new, old)))


def fold_cost(state: AutopilotState, a1: torch.Tensor, a2: torch.Tensor,
              cfg: AutopilotConfig) -> AutopilotState:
    """The act's last step, the realized-cost EMA over a batch's pairs
    (both duelled arms answer the query)."""
    ctrl = state.ctrl
    costs = mp.get_pool(state.inner).costs
    c = torch.mean(0.5 * (costs[a1.long()] + costs[a2.long()]))
    ema = torch.where(ctrl.tick == 1, c,
                      (1.0 - cfg.cost_alpha) * ctrl.cost_ema
                      + cfg.cost_alpha * c)
    return AutopilotState(state.inner, ctrl._replace(cost_ema=ema))


def wrap(pol: RoutingPolicy, cfg: AutopilotConfig, *,
         posterior_fn: Callable | None = None, use_kernel: bool = True,
         act_folds_cost: bool = True) -> RoutingPolicy:
    """The autopiloted twin of a pool-backed policy with an ``act_masked``
    path. ``posterior_fn(inner_state) -> (S, d)`` overrides
    ``POSTERIOR_FNS``; ``use_kernel=False`` takes the dominance matrix's
    plain version. ``act_folds_cost=False`` leaves the realized-cost EMA
    to the caller, ``fold_cost`` on the whole batch's pairs: the mesh
    service, whose act sees only its rank's rows."""
    if pol.act_masked is None:
        raise ValueError(
            f"policy '{pol.name}' has no act_masked path: the autopilot "
            f"enforces candidate quotas inside masked selection — build "
            f"the policy on a ModelPool (pooled constructors provide it)")
    if posterior_fn is None:
        posterior_fn = POSTERIOR_FNS.get(pol.name)

    def init(draws):
        inner = pol.init(draws)
        pool = mp.get_pool(inner)      # raises on a non-pooled policy
        return AutopilotState(inner, init_controller(pool.active))

    def _act(draws, state, x, pref=None):
        inner, ctrl = state.inner, state.ctrl
        pool = mp.get_pool(inner)
        b = x.shape[0]
        k_gate, k_act = draws.split(2)

        # 1. arrivals since the last act become candidates (fresh counters)
        newly = pool.active & ~ctrl.known
        candidate = ctrl.candidate & pool.active
        if cfg.candidates_on_arrival:
            candidate = candidate | newly
        ctrl = ctrl._replace(
            known=pool.active,
            candidate=candidate,
            cand_wins=torch.where(newly, 0.0, ctrl.cand_wins),
            cand_duels=torch.where(newly, 0.0, ctrl.cand_duels),
            tick=ctrl.tick + 1,
        )

        # 2. the control tick every cfg.every acts, selected on the device
        post = None if posterior_fn is None else posterior_fn(inner)
        stepped, dec = step(ctrl, post, pool, cfg, use_kernel=use_kernel)
        on = ctrl.tick % cfg.every == 0
        new_pool = apply_decisions(pool, dec)
        ctrl = _pick(on, stepped, ctrl)
        pool = pool._replace(
            active=torch.where(on, new_pool.active, pool.active),
            generation=torch.where(on, new_pool.generation, pool.generation))
        inner = mp.set_pool(inner, pool)

        # 3. quota gate: only gated rows may see candidate columns; with no
        #    active full member every row may (an all-candidate pool)
        gate = k_gate.uniform((b,), x.device) < cfg.quota
        has_full = torch.any(pool.active & ~ctrl.candidate)
        row_mask = gate[:, None] | ~ctrl.candidate[None, :] | ~has_full

        # 4. gated selection under the governor's live lambda tilt; with a
        #    per-request preference the inner act_pref sees pref + lambda
        if pref is None:
            inner, a1, a2 = pol.act_masked(k_act, inner, x, row_mask,
                                           ctrl.lam * pool.costs)
        else:
            inner, a1, a2 = pol.act_pref(k_act, inner, x, row_mask,
                                         pref + ctrl.lam)

        # 5. realized-cost EMA
        state = AutopilotState(inner, ctrl)
        if act_folds_cost:
            state = fold_cost(state, a1, a2, cfg)
        return state, a1, a2

    def act(draws, state, x):
        return _act(draws, state, x)

    act_pref = None
    if pol.act_pref is not None:
        def act_pref(draws, state, x, row_mask, pref):
            # the autopilot owns the quota gate: an outer row mask is
            # dropped, as in the reference
            del row_mask
            return _act(draws, state, x, pref)

    def _count(ctrl: ControllerState, a1, a2, y, ok) -> ControllerState:
        """Candidate duel accounting on resolved feedback (masked rows are
        absent); a1 wins on y > 0. Duplicate indices accumulate."""
        okf = ok.to(torch.float32)
        i1, i2 = a1.long(), a2.long()
        c1 = ctrl.candidate[i1].to(torch.float32) * okf
        c2 = ctrl.candidate[i2].to(torch.float32) * okf
        wins = ctrl.cand_wins.index_add(0, i1, c1 * (y > 0)) \
            .index_add(0, i2, c2 * (y < 0))
        duels = ctrl.cand_duels.index_add(0, i1, c1).index_add(0, i2, c2)
        return ctrl._replace(cand_wins=wins, cand_duels=duels)

    def update(state, x, a1, a2, y):
        ok = torch.ones(y.shape, dtype=torch.bool, device=y.device)
        return AutopilotState(pol.update(state.inner, x, a1, a2, y),
                              _count(state.ctrl, a1, a2, y, ok))

    update_masked = None
    if pol.update_masked is not None:
        def update_masked(state, x, a1, a2, y, mask):
            return AutopilotState(
                pol.update_masked(state.inner, x, a1, a2, y, mask),
                _count(state.ctrl, a1, a2, y, mask))

    update_delayed = None
    if pol.update_delayed is not None:
        def update_delayed(state, x, a1, a2, y, age):
            ok = torch.ones(y.shape, dtype=torch.bool, device=y.device)
            return AutopilotState(
                pol.update_delayed(state.inner, x, a1, a2, y, age),
                _count(state.ctrl, a1, a2, y, ok))

    update_pref = None
    if pol.update_pref is not None:
        def update_pref(state, x, a1, a2, y, pref, mask):
            return AutopilotState(
                pol.update_pref(state.inner, x, a1, a2, y, pref, mask),
                _count(state.ctrl, a1, a2, y, mask))

    propensity = None
    if pol.propensity is not None:
        def propensity(state, x, a1, a2):
            return pol.propensity(state.inner, x, a1, a2)

    return RoutingPolicy(init, act, update,
                         name=f"autopilot({pol.name})",
                         update_delayed=update_delayed,
                         update_masked=update_masked,
                         act_pref=act_pref,
                         update_pref=update_pref,
                         propensity=propensity)
