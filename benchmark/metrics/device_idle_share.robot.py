"""The share of the frames' time in which the device runs nothing, in %:
over the union of every traced frame's span, from its due time to the end
of the synchronise after the spin that fused it (the gaps between frames
of the 10 Hz schedule are not counted)."""

from benchmark import harness as H


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["device"]:
        return None
    lo, hi = tr["window"]
    frames = sorted((d, e) for d, e in zip(rec["due"], rec["done_at"]) if d >= lo and e == e and e <= hi)
    merged = []
    for a, b in frames:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = sum(b - a for a, b in merged)
    if total <= 0:
        return None
    busy = sum(H.union_seconds([(a, b) for _, a, b in tr["device"]], lo_, hi_) for lo_, hi_ in merged)
    return 100.0 * (1.0 - busy / total)
