"""Online routing core of the port (counterpart of ``repro.core``)."""
