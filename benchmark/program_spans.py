"""What the program's own spans say of a traced unit: launches, device
seconds and device-idle seconds under each `eodt.` span.

The port marks its stages with `eodt.` ranges (`utils/tracing.py` of the
port; they are `torch.profiler` ranges whenever a profiler records). Each
device op that starts in the traced window [t.lo, t.hi] goes to the
innermost `eodt.` span open on the main thread (`common.main_thread`) at
its launch: the time of its `cuda_runtime` (or `cuda_driver`) event, on
whichever thread made it, since autograd launches the backward from its
own device thread while the main thread waits inside
`eodt.train.backward`. Every interval of the window in which no device
op runs is split the same way, by the main thread's innermost span over
each part of it. A span is read whole (with its children) or as its
self part (what no child span covers).

Device seconds and launches are those of the traced unit, whose device
work is an equal unit's. Idle seconds are the traced unit's too: the
profiler stretches the host's time by 40-45 %, so they are larger than
an unprofiled unit's and compare only with other traced readings.

Nothing here imports the port. A program without `eodt.` spans (one
older than them) gives None, and so do the readers that call `per_unit`.
"""

from __future__ import annotations

import bisect
import collections
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

from .common import DEVICE_CATS, kernel_name, main_thread

PREFIX = "eodt."


class Totals(NamedTuple):
    launches: int = 0       # CUDA kernels
    device_s: float = 0.0   # kernels, copies and sets
    idle_s: float = 0.0     # the window's time in which no device op ran

    def add(self, launches: int = 0, device_s: float = 0.0,
            idle_s: float = 0.0) -> "Totals":
        return Totals(self.launches + launches, self.device_s + device_s,
                      self.idle_s + idle_s)


class Spans(NamedTuple):
    whole: Dict[str, Totals]    # by span name, children included
    own: Dict[str, Totals]      # by span name, its self part
    outside: Totals             # under no span
    idle_s: float               # the window's idle time
    # the kernels launched under no span: [(name, launches)], most first
    outside_kernels: List[Tuple[str, int]]
    unlaunched: int             # device ops with no launch event


def segments(spans: List[Tuple[float, float, str]]
             ) -> List[Tuple[float, float, Tuple[str, ...]]]:
    """The nested ranges of one thread, [(start, end, name)], as disjoint
    pieces [(start, end, (outermost, ..., innermost name))] in time order,
    covering the time some range is open. A child that outlasts its parent
    (timestamps rounded apart) is cut at the parent's end."""
    out = []
    stack: List[Tuple[float, str]] = []     # (end, name)
    cursor = 0.0

    def emit(end):
        nonlocal cursor
        if stack and end > cursor:
            out.append((cursor, end, tuple(n for _, n in stack)))
        cursor = max(cursor, end)

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= start:
            emit(stack[-1][0])
            stack.pop()
        emit(start)
        if stack:
            end = min(end, stack[-1][0])
        stack.append((end, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


def device_ops(events: List[dict]) -> List[Tuple[float, float, str, str,
                                                  Optional[float]]]:
    """[(start, end, name, cat, launch ts or None)] of the device ops, in
    time order, each with the time of the CUDA runtime or CUDA driver API
    call that launched it. `common.Trace` maps runtime calls only; on the
    H100 some library kernels are launched through the CUDA driver API
    (1643 of the 137 415 launches of a training step)."""
    launch_at = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = e["ts"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"],
                   launch_at.get(e.get("args", {}).get("correlation")))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def read_spans(trace, lo: float, hi: float) -> Optional[Spans]:
    """The window [lo, hi]'s launches, device and idle seconds by `eodt.`
    span of the main thread; None where the trace has no such span."""
    main = main_thread(trace)
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace.events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("tid") == main
              and e.get("name", "").startswith(PREFIX)]
    if not ranges:
        return None
    pieces = segments(ranges)
    starts = [p[0] for p in pieces]
    names = {r[2] for r in ranges}
    whole = {n: Totals() for n in names}
    own = {n: Totals() for n in names}
    outside = Totals()
    outside_kernels: collections.Counter = collections.Counter()
    unlaunched = 0

    def credit(stack, **kw):
        nonlocal outside
        if not stack:
            outside = outside.add(**kw)
            return
        for n in set(stack):
            whole[n] = whole[n].add(**kw)
        own[stack[-1]] = own[stack[-1]].add(**kw)

    def at(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return pieces[i][2] if i >= 0 and ts < pieces[i][1] else ()

    # the device ops, by their launch
    gaps, end = [], lo
    for s, e, name, cat, launch in device_ops(trace.events):
        if s >= hi:
            break
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if s < lo:
            continue
        unlaunched += launch is None
        stack = at(launch) if launch is not None else ()
        if not stack and cat == "kernel":
            outside_kernels[kernel_name(name)] += 1
        credit(stack, launches=int(cat == "kernel"), device_s=(e - s) / 1e6)
    if hi > end:
        gaps.append((end, hi))
    # the idle time, by the main thread's span over each part of it
    idle = 0.0
    for a, b in gaps:
        idle += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        cursor = a
        while i < len(pieces) and pieces[i][0] < b:
            p0, p1, stack = pieces[i]
            s, e = max(p0, a), min(p1, b)
            if e > s:
                if s > cursor:
                    credit((), idle_s=(s - cursor) / 1e6)
                credit(stack, idle_s=(e - s) / 1e6)
                cursor = e
            i += 1
        if b > cursor:
            credit((), idle_s=(b - cursor) / 1e6)
    return Spans(whole, own, outside, idle / 1e6,
                 outside_kernels.most_common(), unlaunched)


def spans_of(t) -> Optional[Spans]:
    """`read_spans` of a TraceView's window, read once a run; the first
    reading prints the spans' numbers to standard error."""
    if not hasattr(t, "_program_spans"):
        got = read_spans(t.trace, t.lo, t.hi)
        t._program_spans = got
        if got is not None:
            report(got, t.frames, t.steps)
    return t._program_spans


def report(got: Spans, frames: int, steps: int) -> None:
    idle = got.idle_s
    share = 100.0 * got.outside.idle_s / idle if idle else 0.0
    print(f"program spans: {got.outside.idle_s * 1e3:.3f} ms of the traced "
          f"unit's {idle * 1e3:.3f} ms of device idle ({share:.2f} %) lie "
          f"under no eodt. span; outside every span "
          f"{got.outside.launches} launches, "
          f"{got.outside.device_s * 1e3:.3f} ms device "
          f"({frames} frames, {steps} steps a unit); {got.unlaunched} "
          f"device ops with no launch event; launched under no span: "
          + ", ".join(f"{n} x{k}" for n, k in got.outside_kernels[:8]),
          file=sys.stderr)
    for name in sorted(got.whole):
        w, o = got.whole[name], got.own[name]
        print(f"span {name}: whole {w.launches} launches, "
              f"{w.device_s * 1e3:.3f} ms device, {w.idle_s * 1e3:.3f} ms "
              f"idle; self {o.launches}, {o.device_s * 1e3:.3f} ms, "
              f"{o.idle_s * 1e3:.3f} ms (the traced unit)", file=sys.stderr)


def per_unit(t, name: str, field: str, per: str,
             whole: bool = True) -> Optional[float]:
    """Span `name`'s `field` ("launches", "device_s" or "idle_s"; seconds
    read in ms), whole or its self part, over the unit's frames (`per`
    "frame") or steps ("step"); None where the program has no such
    span."""
    got = spans_of(t)
    table = None if got is None else got.whole if whole else got.own
    if table is None or name not in table:
        return None
    value = getattr(table[name], field)
    if field != "launches":
        value *= 1e3
    return value / (t.frames if per == "frame" else t.steps)
