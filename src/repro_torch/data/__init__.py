"""Data of the port (counterpart of ``repro.data``): the synthetic corpus,
RouterBench and MixInstruct, the pipeline from query tokens to the online
environment, and the candidate-pool registry."""
from . import mixinstruct, pipeline, pool, routerbench, synth

__all__ = ["mixinstruct", "pipeline", "pool", "routerbench", "synth"]
