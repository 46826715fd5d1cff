"""The host's time to issue one map update's launches, in ms: the median
``core.update`` span inside ``mapper.input_pointcloud`` in the window's
untraced part (it returns before the card has done the work)."""

from benchmark import program_spans as P


def _update(kids, s):
    ups = [k for k in kids.get(s.sid, []) if k.name == "core.update"]
    return ups[0].ms if ups else None


def read(rec):
    return P.median_per(rec, "mapper.input_pointcloud", _update)
