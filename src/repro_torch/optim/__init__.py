"""Samplers of the port (counterpart of ``repro.optim``)."""
