"""Drivers of the port (counterpart of ``repro.launch``): the serving
driver ``serve``."""
