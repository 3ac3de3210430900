"""The points at which a block's full-sequence forward runs as one rank
of a sharded program.

``blocks.block_fwd`` and the mixers it calls take a ``hooks`` object and
call it at each projection boundary, naming the weight whose split
implies the step, and for each kernel wrapper or MoE FFN they run
(``impl``). ``LOCAL``, the default, is one device: every hook passes its
input on and ``impl`` returns the function it is given, so the
single-device path costs one Python call a hook and nothing else.
``launch/dryrun.py::RankHooks`` is the rank program of the production
meshes (its collectives, and its kernels or their stand-ins).
"""
from __future__ import annotations


class Local:
    """One device: the identity at every hook."""

    def sub(self, name: str) -> "Local":
        """The hooks of the block's sub-tree ``name`` (mixer, xattn,
        ffn)."""
        return self

    def enter(self, x, weight: str):
        """x before the column-parallel projection ``weight``."""
        return x

    def leave(self, x, weight: str):
        """The output of the row-parallel projection ``weight``."""
        return x

    def heads(self, q, k, v):
        """Projected q, k, v (B,S,heads,hd), before RoPE."""
        return q, k, v

    def head_out(self, o):
        """The attention's output (B,S,heads,hd), before ``wo``."""
        return o

    def channels(self, u):
        """The RG-LRU's conv output (B,S,dr), as its gates read it."""
        return u

    def keep(self, y, weight: str):
        """The input of the row-parallel projection ``weight``."""
        return y

    def impl(self, fn):
        """The function to run for ``fn`` (a kernel wrapper or
        ``moe.moe_ffn``)."""
        return fn


LOCAL = Local()
