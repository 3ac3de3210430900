"""Runtime graph-flatness assertion: the dynamic twin of the port's
repro-lint (counterpart of ``repro/analysis/retrace.py``, the same API and
messages).

The static passes catch capture *hazards*; this module pins the actual
contract at run time: a block of serving traffic — membership changes,
pref sweeps, control ticks, restores — must capture **zero** new CUDA
graphs. ``RouterService.compiled_program_counts()`` counts the streaming
programs per surface and, under ``captures``, the graphs captured so far.

``assert_flat`` snapshots per-program compile counts on entry and
re-checks them on exit (and at any explicit ``check()`` point), raising
``AssertionError`` with a per-program diff on violation.  Targets are
anything with a ``compiled_program_counts() -> dict[str, int]`` method
(``RouterService``), a zero-arg callable returning such a dict, or a
plain dict-returning snapshot already taken.

Usage::

    with assert_flat(svc):
        svc.route_stream(x, prefs=torch.full((8,), 2.0))
        svc.feedback_batch(t, y)

    with assert_flat(svc, note="hot swap") as flat:
        svc.swap_model("m1", new_entry)
        flat.check("after swap")      # mid-block checkpoint
        svc.route_batch(x)

``chip_smoke.py`` holds its streaming, refresh and mesh phases' graph
counts flat through it.
"""
from __future__ import annotations


def _snapshot(target) -> dict[str, int]:
    counts = getattr(target, "compiled_program_counts", None)
    if counts is not None:
        return dict(counts())
    if callable(target):
        return dict(target())
    raise TypeError(
        f"assert_flat target {target!r} has no compiled_program_counts() "
        "and is not a zero-arg callable")


def _diff(before: dict[str, int], after: dict[str, int]) -> list[str]:
    lines = []
    for name in sorted(set(before) | set(after)):
        b, a = before.get(name, 0), after.get(name, 0)
        if a != b:
            lines.append(f"  {name}: {b} -> {a} (+{a - b})")
    return lines


class assert_flat:
    """Context manager asserting no new programs are compiled (no new
    CUDA graphs captured).

    Parameters
    ----------
    *targets:
        Objects exposing ``compiled_program_counts()`` or zero-arg
        callables returning ``{program_name: count}``.
    note:
        Context string prefixed to the assertion message.
    """

    def __init__(self, *targets, note: str = ""):
        if not targets:
            raise TypeError("assert_flat needs at least one target")
        self._targets = targets
        self._note = note
        self._before: list[dict[str, int]] | None = None

    def __enter__(self) -> "assert_flat":
        self._before = [_snapshot(t) for t in self._targets]
        return self

    def check(self, note: str = "") -> None:
        """Assert flatness right now, without closing the block."""
        assert self._before is not None, "check() outside the with-block"
        self._compare(note or self._note)

    def _compare(self, note: str) -> None:
        assert self._before is not None
        for i, t in enumerate(self._targets):
            diff = _diff(self._before[i], _snapshot(t))
            if diff:
                label = f" [{note}]" if note else ""
                raise AssertionError(
                    f"retrace detected{label}: new programs compiled for "
                    f"target #{i}:\n" + "\n".join(diff))

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._compare(self._note)
        self._before = None
        return False
