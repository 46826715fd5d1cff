"""The share of the traced part of the window in which the device runs
nothing, in %."""

from benchmark import harness as H


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["device"]:
        return None
    lo, hi = tr["window"]
    return 100.0 * (1.0 - H.union_seconds([(a, b) for _, a, b in tr["device"]], lo, hi) / (hi - lo))
