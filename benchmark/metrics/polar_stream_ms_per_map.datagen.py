"""The polar visibility cleanup's stream time per map update, in ms: over
the ``batch.update`` spans in the window's traced part, the device-stream
time between the CUDA events of their ``raycast.polar_cube`` and
``raycast.polar_evaluate`` child spans, summed, over the maps those steps
updated. Stream time between two events includes any idle stretch of the
stream between them, so the number is the stages' device time only where
the stream has no such stretch: in a device-bound cell (64 maps a step), not
in a host-bound one, where it holds the host's issue gaps."""

from benchmark import program_spans as P

POLAR = ("raycast.polar_cube", "raycast.polar_evaluate")


def read(rec):
    spans = P.ring()
    window = P.traced(rec)
    if not spans or window is None:
        return None
    kids = P.by_parent(spans)
    total, maps = 0.0, 0
    for step in P.started_in(spans, "batch.update", *window):
        polar = [k for k in kids.get(step.sid, []) if k.name in POLAR]
        if len(polar) != len(POLAR) or any(k.stream_ms is None for k in polar):
            continue
        total += sum(k.stream_ms for k in polar)
        maps += step.attrs.get("maps", rec["maps"])
    return total / maps if maps else None
