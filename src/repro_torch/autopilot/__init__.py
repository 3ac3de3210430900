"""Pool autopilot: posterior-dominance auto-retirement, A/B candidate
slots with traffic quotas, and a closed-loop cost governor over the
dynamic ``ModelPool`` (counterpart of ``repro/autopilot``)."""
from .controller import (POSTERIOR_FNS, AutopilotConfig, AutopilotState,
                         ControllerState, Decisions, apply_decisions,
                         init_controller, step, wrap)
from .dominance import (dominance_matrix, dominated_by_cheaper,
                        posterior_scores_ref, win_matrix)

__all__ = [
    "POSTERIOR_FNS", "AutopilotConfig", "AutopilotState", "ControllerState",
    "Decisions", "apply_decisions", "init_controller", "step", "wrap",
    "dominance_matrix", "dominated_by_cheaper", "posterior_scores_ref",
    "win_matrix",
]
