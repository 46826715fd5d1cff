"""The host's cost of issuing one map update, in ms: the median span of
the mapper's ``input_pointcloud``, which returns before the card has done
the work. Spans outside the traced part of the window."""

from benchmark import harness as H


def read(rec):
    return H.median([(b - a) * 1e3 for _, a, b, _ in rec["spans"].of("mapper.input_pointcloud", traced=False)])
