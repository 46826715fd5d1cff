"""The mapping service's time to drain one frame, in ms: over the spins
that fused a frame in the window's untraced part, the program's
``service.drain`` spans of the spin (ring pop, header unpack, native
deinterleave, ``SensorFrame``; the last, empty pop included) over the frames
it fused (``service.fuse``); the median of those."""

from benchmark import program_spans as P


def _per_frame(kids, spin):
    mine = kids.get(spin.sid, [])
    frames = sum(1 for s in mine if s.name == "service.fuse")
    return P.child_ms(kids, spin, ("service.drain",)) / frames if frames else None


def read(rec):
    return P.median_per(rec, "service.spin_once", _per_frame)
