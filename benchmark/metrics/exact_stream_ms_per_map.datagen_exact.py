"""The exact visibility cleanup's stream time per map update, in ms: over
the ``batch.update`` spans in the window's traced part, the device-stream
time between the CUDA events of their ``raycast.exact`` child span (the
pack, the gate table, K2 and the layers' update), summed, over the maps
those steps updated. As ``polar_stream_ms_per_map.datagen``, it is the
stage's device time only where the stream has no idle stretch inside the
span. A program without the span gives None."""

from benchmark import program_spans as P


def read(rec):
    spans = P.ring()
    window = P.traced(rec)
    if not spans or window is None:
        return None
    kids = P.by_parent(spans)
    total, maps = 0.0, 0
    for step in P.started_in(spans, "batch.update", *window):
        exact = [k for k in kids.get(step.sid, []) if k.name == "raycast.exact"]
        if len(exact) != 1 or exact[0].stream_ms is None:
            continue
        total += exact[0].stream_ms
        maps += step.attrs.get("maps", rec["maps"])
    return total / maps if maps else None
