"""K2's share of its memory roofline over its launches in the traced part
of the window, in % (``exact_march.k2_roofline``; the launches' shapes as
the driver ``batched_steps_exact`` records them)."""

from benchmark import exact_march as K2


def read(rec):
    return K2.k2_roofline(rec["trace"], rec.get("k2"))
