"""The host's time to issue the polar visibility cleanup of one map
update, in ms: the median, over the ``core.update`` spans in the window's
untraced part, of their ``raycast.polar_cube`` plus ``raycast.polar_evaluate``
child spans."""

from benchmark import program_spans as P

POLAR = ("raycast.polar_cube", "raycast.polar_evaluate")


def _polar(kids, s):
    mine = [k for k in kids.get(s.sid, []) if k.name in POLAR]
    return sum(k.ms for k in mine) if mine else None


def read(rec):
    return P.median_per(rec, "core.update", _polar)
