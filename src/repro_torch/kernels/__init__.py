"""Hand-written CUDA kernels of the port, each beside its plain version.

Each wrapper dispatches on the device of its tensors (CPU: plain PyTorch;
CUDA: the kernel, or an error) and counts its kernel launches in a plain
integer attribute ``launches``. Nothing is compiled at import: see
``_build``. (The ``dueling_score`` function is reached through its module,
``kernels.dueling_score.dueling_score``, whose name it would shadow here.)
"""
from . import dueling_score as _scores
from .dueling_score import dueling_select, mask_fallback_pair, posterior_scores
from .sgld_update import (mixed_potential_grad_rows, mixed_potential_rows,
                          potential_grad_rows, potential_rows,
                          resolve_sgld_backend, sgld_mixed_potential,
                          sgld_potential)

# name -> wrapper, for reading and resetting the launch counts
WRAPPERS = {
    "dueling_select": dueling_select,
    "sgld_potential_fwd": potential_rows,
    "sgld_potential_grad": potential_grad_rows,
    "dueling_score": _scores.dueling_score,
    "sgld_mixed_fwd": mixed_potential_rows,
    "sgld_mixed_grad": mixed_potential_grad_rows,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "dueling_select", "launch_counts",
           "mask_fallback_pair", "mixed_potential_grad_rows",
           "mixed_potential_rows", "posterior_scores", "potential_grad_rows",
           "potential_rows", "reset_launch_counts", "resolve_sgld_backend",
           "sgld_mixed_potential", "sgld_potential"]
