"""Copies between host and card that make the host wait, per batched
step's image path: the ``blocking_transfers`` counted inside the
``batch.input_image`` spans of the window's untraced part, over those spans
(the Bresenham walk's early-exit reads; 0 for an occlusion test that never
reads back). A program without the span gives None."""

from benchmark import program_spans as P


def read(rec):
    spans = P.ring()
    if not spans:
        return None
    steps = P.started_in(spans, "batch.input_image", *P.untraced(rec))
    return sum(s.transfers for s in steps) / len(steps) if steps else None
