"""Device milliseconds per fused frame in the traced part of the window:
the summed durations of every device operation over the frames the spins
in it fused."""

from benchmark import harness as H


def read(rec):
    frames = sum(a.get("frames", 0) for *_, a in rec["spans"].of("service.spin_once", traced=True))
    ops, seconds = H.device_seconds(rec["trace"])
    return seconds * 1e3 / frames if frames and ops else None
