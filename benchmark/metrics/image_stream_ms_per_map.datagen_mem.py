"""The image path's stream time per map, in ms: over the
``batch.input_image`` spans in the window's traced part, the device-stream
time between their CUDA events (the projection, the occlusion test and the
fusions), summed, over the maps those steps fused. The Bresenham walk reads
the device back every few of its steps, and the stream idles while the host
waits and issues again: those stretches count too, as in
``polar_stream_ms_per_map.datagen``. A program without the span gives
None."""

from benchmark import program_spans as P


def read(rec):
    spans = P.ring()
    window = P.traced(rec)
    if not spans or window is None:
        return None
    total, maps = 0.0, 0
    for s in P.started_in(spans, "batch.input_image", *window):
        if s.stream_ms is None:
            continue
        total += s.stream_ms
        maps += s.attrs.get("maps", rec["maps"])
    return total / maps if maps else None
