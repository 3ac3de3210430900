"""Sharding rules of the port (counterpart of ``repro.sharding``): the
routing service's in ``routing_rules``."""
