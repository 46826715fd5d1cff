"""The host's time in a batched step's image path, in ms: the median host
time of the ``batch.input_image`` spans in the window's untraced part, the
waits for the Bresenham walk's read-backs included. A program without the
span gives None."""

from benchmark import program_spans as P


def read(rec):
    return P.median_per(rec, "batch.input_image", lambda kids, span: span.ms)
