"""Device operations per batched step in the traced part of the window."""

from benchmark import harness as H


def read(rec):
    steps = len(rec["spans"].of("batched.step", traced=True))
    ops, _ = H.device_seconds(rec["trace"])
    return ops / steps if steps and ops else None
