"""Device milliseconds per map update in the traced part of the window:
the summed durations of every device operation over the steps issued in
it times the maps a step."""

from benchmark import harness as H


def read(rec):
    steps = len(rec["spans"].of("batched.step", traced=True))
    ops, seconds = H.device_seconds(rec["trace"])
    return seconds * 1e3 / (steps * rec["maps"]) if steps and ops else None
