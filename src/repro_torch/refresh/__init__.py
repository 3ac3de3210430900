"""Online representation loop: duel logging, causal CCFT refresh, table
swap (counterpart of ``repro.refresh``).

``duel_log`` is the serving-side capture (the ring fold, the host export);
``trainer`` the offline job (IPW duel scores -> CCFT weighting ->
refreshed (K_max, d) table) and the ``RefreshSchedule`` of ``env.run``.
The swap itself is ``core.model_pool.set_table`` and
``serving.RouterService.apply_table``.
"""
from repro_torch.refresh.duel_log import DuelLog, export, fold, init_log
from repro_torch.refresh.trainer import (RefreshConfig, RefreshSchedule,
                                         apply_refresh, assign_categories,
                                         category_mix, duel_scores,
                                         refresh_table, schedule)

__all__ = [
    "DuelLog", "init_log", "fold", "export",
    "RefreshConfig", "RefreshSchedule", "apply_refresh", "assign_categories",
    "category_mix", "duel_scores", "refresh_table", "schedule",
]
