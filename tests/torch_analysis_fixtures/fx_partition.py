"""Seeded partition-spec coverage drift + clean twins, in the port's
spelling (``routing_rules.P``).

Parsed by tests/test_torch_analysis.py, never executed.
"""
from typing import NamedTuple

from repro_torch.sharding.routing_rules import P


class Ring(NamedTuple):
    x: object
    a1: object
    valid: object
    pref: object


def specs_missing(bx):
    # `pref` grew on the record but the spec map was never updated
    return Ring(x=P(bx, None), a1=P(bx), valid=P(bx))  # PLANT: partition/missing-field


def specs_stale_rename(bx):
    # rename drift: the record says `pref`, the map says `prefs`
    return Ring(  # PLANT: partition/missing-field partition/unknown-field
        x=P(bx, None),
        a1=P(bx),
        valid=P(bx),
        prefs=P(bx),
    )


# --------------------------- clean twins -----------------------------------

def specs_ok(bx):
    rows = P(bx)
    return Ring(x=P(bx, None), a1=rows, valid=rows, pref=rows)


def data_ok(x, a1, valid, pref):
    # ordinary data construction: not a spec map, never checked
    return Ring(x=x, a1=a1, valid=valid, pref=pref)
