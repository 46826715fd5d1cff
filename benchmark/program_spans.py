"""The program's own spans, for the per-layer metrics that read them.

The program keeps its spans in a ring (``elevation_mapping_cupy_torch.
tracing``): each has a name, a parent, ``t0_ns`` and ``t1_ns`` on
``time.perf_counter_ns()`` (the clock of the benchmark's windows), the
blocking transfers made inside it and, for the update's stages in a traced
window, ``stream_ms``. A program without that module has no spans: every
function here then returns None, and so does the metric.

Host times are read in the window's untraced part, [window start, trace
start), where the profiler adds nothing; stream times in the traced part.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark import harness as H


def ring() -> Optional[List]:
    """The program's closed spans (the window ends in a synchronise, so their
    stream times can be read); None for a program without the ring."""
    try:
        from elevation_mapping_cupy_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def untraced(rec: Dict) -> Tuple[float, float]:
    """[window start, trace start) in seconds; the whole window untraced."""
    tr = rec.get("trace")
    return rec["window_start"], (tr["window"][0] if tr else rec["window_end"])


def traced(rec: Dict) -> Optional[Tuple[float, float]]:
    tr = rec.get("trace")
    return tuple(tr["window"]) if tr else None


def started_in(spans: List, name: str, lo: float, hi: float) -> List:
    """The spans of ``name`` that started in [lo, hi) (seconds)."""
    lo_ns, hi_ns = lo * 1e9, hi * 1e9
    return [s for s in spans if s.name == name and lo_ns <= s.t0_ns < hi_ns]


def by_parent(spans: List) -> Dict[int, List]:
    out: Dict[int, List] = {}
    for s in spans:
        if s.parent is not None:
            out.setdefault(s.parent, []).append(s)
    return out


def child_ms(kids: Dict[int, List], of, names) -> float:
    """Host ms of the children of ``of`` named in ``names``."""
    return sum(s.ms for s in kids.get(of.sid, []) if s.name in names)


def median_per(rec: Dict, parent: str, part) -> Optional[float]:
    """The median, over the spans of ``parent`` in the untraced part of
    the window, of ``part(kids, span)`` (None where it gives None)."""
    spans = ring()
    if not spans:
        return None
    kids = by_parent(spans)
    vals = [part(kids, s) for s in started_in(spans, parent, *untraced(rec))]
    return H.median([v for v in vals if v is not None])
