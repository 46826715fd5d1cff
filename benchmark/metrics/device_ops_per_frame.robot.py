"""Device operations per fused frame in the traced part of the window:
everything the card ran (kernels, copies, fills) over the frames the spins
in it fused."""

from benchmark import harness as H


def read(rec):
    frames = sum(a.get("frames", 0) for *_, a in rec["spans"].of("service.spin_once", traced=True))
    ops, _ = H.device_seconds(rec["trace"])
    return ops / frames if frames and ops else None
