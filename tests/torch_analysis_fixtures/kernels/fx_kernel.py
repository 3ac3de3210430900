"""Seeded hand-kernel dispatch and budget violations + clean twins.

Lives under a ``kernels/`` path on purpose: the kernel rules hold the
port's kernel wrappers. Parsed by tests/test_torch_analysis.py, never
executed.
"""
import torch

SELECT_SMEM_BYTES = 227 * 1024           # a block's shared memory on Hopper
WIDE_SMEM_BYTES = 2 * SELECT_SMEM_BYTES  # PLANT: kernel/smem-budget
RING_SMEM_BYTES = SELECT_SMEM_BYTES - 12 * 1024


def score_plain(x):
    return x * 2.0


def _launch(x):
    return x


def score_bad_try(x):
    try:
        return _launch(x)
    except RuntimeError:  # PLANT: kernel/silent-fallback
        return score_plain(x)


def score_bad_probe(x):
    if not torch.cuda.is_available():  # PLANT: kernel/silent-fallback
        return score_plain(x)
    return _launch(x)


def score_bad_capability(x):
    major = torch.cuda.get_device_capability()[0]
    return _launch(x) if torch.cuda.get_device_capability()[0] >= 9 else score_plain(x)  # PLANT: kernel/silent-fallback


# --------------------------- clean twins -----------------------------------

def score(x):
    # dispatch on the tensor's device: plain for the CPU, kernel or raise
    if x.device.type == "cpu":
        return score_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"score: tensors on {x.device}")
    return _launch(x)


def score_or_raise(x):
    try:
        return _launch(x)
    except RuntimeError as e:
        raise RuntimeError("the score kernel failed to launch") from e
