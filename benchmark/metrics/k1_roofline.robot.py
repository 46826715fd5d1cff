"""K1's share of its memory roofline over its launches in the traced part
of the window, in % (``harness.k1_roofline``)."""

from benchmark import harness as H


def read(rec):
    return H.k1_roofline(rec["trace"])
