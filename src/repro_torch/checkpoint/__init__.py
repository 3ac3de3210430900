"""Checkpoints of the port, in the reference's msgpack format (counterpart
of ``repro.checkpoint``)."""
from .msgpack_ckpt import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
