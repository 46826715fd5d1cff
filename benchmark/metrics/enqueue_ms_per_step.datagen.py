"""The host's cost of issuing one batched step, in ms: the median span of
a step (the move, the update, and at an episode's start the fresh maps),
which returns before the card has done the work. Spans outside the traced
part of the window."""

from benchmark import harness as H


def read(rec):
    return H.median([(b - a) * 1e3 for _, a, b, _ in rec["spans"].of("batched.step", traced=False)])
