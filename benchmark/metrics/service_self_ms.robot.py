"""The mapping service's own host time per frame, in ms: the median over
the spins that fused a frame of ``spin_once``'s span minus the spans of the
calls it made into its map, divided by the frames that spin fused. Spans
outside the traced part of the window, where the profiler adds nothing."""

from benchmark import harness as H


def read(rec):
    spans = rec["spans"]
    calls = [s for s in spans.items if s[0].startswith("mapper.") and not s[3].get("traced")]
    own = []
    for _, a, b, attrs in spans.of("service.spin_once", traced=False):
        if attrs.get("frames", 0) < 1:
            continue
        inner = sum(d - c for _, c, d, _ in calls if c >= a and d <= b)
        own.append((b - a - inner) / attrs["frames"] * 1e3)
    return H.median(own)
