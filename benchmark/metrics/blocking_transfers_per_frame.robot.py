"""Copies between host and card that make the host wait, per fused frame:
the ``blocking_transfers`` the program's top-level spans counted in the
window's untraced part (frames, poses, timers, publishes) over the frames
fused there (``service.fuse`` spans)."""

from benchmark import program_spans as P


def read(rec):
    spans = P.ring()
    if not spans:
        return None
    lo, hi = P.untraced(rec)
    frames = len(P.started_in(spans, "service.fuse", lo, hi))
    lo_ns, hi_ns = lo * 1e9, hi * 1e9
    transfers = sum(s.transfers for s in spans if s.parent is None and lo_ns <= s.t0_ns < hi_ns)
    return transfers / frames if frames else None
