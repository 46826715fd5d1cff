"""The port's tracing: host spans in a bounded ring, and the count of
blocking transfers.

A span is a named stretch of host time::

    with tracing.span("mapper.filter"):
        ...

Each closed span is kept in a ring of the last ``RING_SIZE`` spans, with
its name, its id, the id of the request that caused it, its parent span,
its thread, ``t0_ns`` and ``t1_ns`` on ``time.perf_counter_ns()`` (the clock
the benchmark's own spans use), the blocking transfers made inside it and
its attributes. The request id is the caller's (the mapping service passes
a frame's stamp); a span opened without one inherits its parent's, and a
span with no parent starts a new request, numbered per call. That part is
always on: two clock reads and one append per span. Nothing is written to
disk and no thread is started.

While a ``torch.profiler`` runs, each span also opens a
``torch.profiler.record_function`` range of the same name, so that a
profiler trace shows the program's spans on the profiler's clock, and a
span opened with ``stream=True`` records a pair of CUDA timing events on
the current stream. The events are read when a record's ``stream_ms`` is
asked for, after the caller has synchronised, never on the hot path.

Blocking transfers: the copies between host and device that make the host
wait go through :func:`upload` and :func:`read_back` (every such copy of the
update path, the mapper's exports and the service), which count each one in
the innermost open span's ``transfers`` (a span adds its children's) and in
the process's total, :func:`blocking_transfers`.
"""

from __future__ import annotations

import collections
import itertools
import statistics
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = [
    "RING_SIZE", "span", "spans", "summary", "upload", "read_back", "blocking_transfers",
]

# spans kept: the last RING_SIZE closed ones
RING_SIZE = 65536

_ring: "collections.deque[span]" = collections.deque(maxlen=RING_SIZE)
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_blocking = [0]


def _profiling() -> bool:
    """True while a torch.profiler is recording (a module flag that the
    profiler flips when it starts and stops)."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> List["span"]:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.thread = threading.get_ident()
        return _local.stack


class span:
    """A span of host time, used as a context manager; the object itself
    is the record the ring keeps. ``rid`` is the request id (inherited from
    the parent span when not given); ``stream=True`` marks a stage whose
    device time is timed with CUDA events while a profiler runs; the other
    keywords are kept as ``attrs``."""

    __slots__ = ("name", "sid", "rid", "parent", "thread", "t0_ns", "t1_ns", "transfers", "attrs", "stream",
                 "_stream_ms", "_range", "_events")

    def __init__(self, name: str, rid: Any = None, stream: bool = False, **attrs):
        self.name = name
        self.rid = rid
        self.stream = stream
        self.attrs = attrs
        self.parent = None
        self.transfers = 0
        self._stream_ms = None
        self._range = self._events = None

    def __enter__(self) -> "span":
        stack = _stack()
        self.sid = next(_span_ids)
        if stack:
            up = stack[-1]
            self.parent = up.sid
            if self.rid is None:
                self.rid = up.rid
        elif self.rid is None:
            self.rid = next(_request_ids)
        self.thread = _local.thread
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if self.stream:
                self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if self._range is not None:
            if self._events is not None:
                self._events[1].record()
            self._range.__exit__(None, None, None)
            self._range = None
        if stack:
            stack[-1].transfers += self.transfers
        _ring.append(self)
        return False

    @property
    def ms(self) -> float:
        """Host milliseconds from entry to exit."""
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def stream_ms(self) -> Optional[float]:
        """Device-stream milliseconds between the span's two events: None
        for a span without events, or whose end the stream has not reached
        yet (synchronise first)."""
        if self._events is not None and self._events[1].query():
            self._stream_ms = float(self._events[0].elapsed_time(self._events[1]))
            self._events = None
        return self._stream_ms

    def __repr__(self) -> str:
        return (f"span({self.name!r}, sid={self.sid}, rid={self.rid!r}, parent={self.parent}, "
                f"ms={self.ms:.3f}, transfers={self.transfers})")


def spans(since_ns: Optional[int] = None) -> List[span]:
    """The closed spans in the ring, oldest first (those that started at
    ``since_ns`` or later, when given)."""
    return [s for s in list(_ring) if since_ns is None or s.t0_ns >= since_ns]


def summary(among: Optional[List[span]] = None) -> Dict[str, Dict[str, float]]:
    """Per span name, in order of first appearance: ``count``, ``median_ms``
    and ``total_ms`` of host time, ``self_ms`` (the total minus that of the
    span's children) and ``stream_ms`` (summed event times; None where no
    span of the name has events)."""
    among = spans() if among is None else among
    child_ns: Dict[int, int] = collections.defaultdict(int)
    for s in among:
        if s.parent is not None:
            child_ns[s.parent] += s.t1_ns - s.t0_ns
    by_name: Dict[str, List[span]] = {}
    for s in among:
        by_name.setdefault(s.name, []).append(s)
    out = {}
    for name, group in by_name.items():
        host = [s.ms for s in group]
        streams = [s.stream_ms for s in group if s.stream_ms is not None]
        out[name] = {
            "count": len(group),
            "median_ms": statistics.median(host),
            "total_ms": sum(host),
            "self_ms": sum(host) - sum(child_ns.get(s.sid, 0) for s in group) / 1e6,
            "stream_ms": sum(streams) if streams else None,
        }
    return out


def _count_blocking() -> None:
    _blocking[0] += 1
    stack = _stack()
    if stack:
        stack[-1].transfers += 1


def upload(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (a NumPy array, a Python number or sequence, or a tensor) as a
    tensor on ``device``. Anything that is not already a tensor there is
    copied with the host waiting for the device's stream (a pageable copy),
    and counted as one blocking transfer, on any device, so that a path
    counts the same on the CPU as on the card."""
    dev = torch.device(device)
    if isinstance(x, torch.Tensor) and x.device.type == dev.type and dev.index in (None, x.device.index):
        return x if dtype is None else x.to(dtype)
    _count_blocking()
    return torch.as_tensor(x, dtype=dtype, device=device)


def read_back(x: torch.Tensor, copy: bool = False) -> np.ndarray:
    """``x`` as host NumPy (a copy of it with ``copy``, also on the CPU),
    counted as one blocking transfer."""
    _count_blocking()
    return x.to("cpu", copy=copy).numpy()


def blocking_transfers() -> int:
    """The blocking transfers this process has made so far."""
    return _blocking[0]
