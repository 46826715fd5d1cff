"""The host's time to issue a batched step's exact visibility cleanup, in
ms: the median, over the ``batch.update`` spans in the window's untraced
part, of their ``raycast.exact`` child spans' host time. A program that
cleans up map by map issues that many marches inside it; one without the
span gives None."""

from benchmark import program_spans as P


def read(rec):
    def exact_ms(kids, step):
        names = {k.name for k in kids.get(step.sid, [])}
        return P.child_ms(kids, step, ("raycast.exact",)) if "raycast.exact" in names else None

    return P.median_per(rec, "batch.update", exact_ms)
