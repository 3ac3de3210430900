"""Data of the port (counterpart of ``repro.data``): the synthetic corpus,
RouterBench and MixInstruct, and the pipeline from query tokens to the
online environment."""
from . import mixinstruct, pipeline, routerbench, synth

__all__ = ["mixinstruct", "pipeline", "routerbench", "synth"]
