"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer metrics and the breakdown read.

The window runs from the first ``portbench.submit`` span to the end of the
last ``portbench.wait`` span, on the profiler's clock. The device is busy
where any kernel, copy or fill runs: the union of their intervals, so work
that overlaps counts once (the spans' own mirror on the device's timeline
is left out). An idle gap is labelled by what the launching
thread was doing at its middle: the benchmark's span, the outermost
operation inside it and the innermost one.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

SPANS = ("portbench.submit", "portbench.wait")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]            # device seconds by full name
    device_ops: List[Tuple[str, float]]   # the TOP names by device time
    idle_gaps: List[Tuple[str, float]]    # the TOP labels by idle time

    def seconds_of(self, names) -> float:
        """Device seconds of every kernel whose name holds one of
        ``names``."""
        return sum(s for full, s in self.kernel_s.items()
                   if any(n in full for n in names))


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:120]


def reduce(events) -> Trace:
    """``events``: ``prof.events()`` of a profile with CPU and CUDA
    activities over the traced window."""
    from torch.autograd import DeviceType

    spans = [e for e in events
             if e.name in SPANS and e.device_type != DeviceType.CUDA]
    if not spans:
        raise RuntimeError("the trace holds no portbench span")
    t0 = min(e.time_range.start for e in spans)
    t1 = max(e.time_range.end for e in spans)
    main = spans[0].thread
    dev, cpu = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors the benchmark's spans onto the device's
            # timeline as annotations: they are no device work
            if e.name not in SPANS and hi > t0 and lo < t1:
                dev.append((max(lo, t0), min(hi, t1), e.name))
        elif e.thread == main and hi > t0 and lo < t1:
            cpu.append((lo, hi, e.name))
    kernel_us = collections.Counter()
    for lo, hi, name in dev:
        kernel_us[name] += hi - lo
    busy = _union([(lo, hi) for lo, hi, _ in dev])
    busy_us = sum(hi - lo for lo, hi in busy)
    gaps, edge = [], t0
    for lo, hi in busy:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    if t1 > edge:
        gaps.append((edge, t1))

    # what the launching thread did at each gap's middle (events on one
    # thread nest, so a stack of open events holds the answer)
    cpu.sort(key=lambda e: (e[0], -e[1]))
    idle = collections.Counter()
    stack, i = [], 0
    for lo, hi in sorted(gaps):
        mid = 0.5 * (lo + hi)
        while i < len(cpu) and cpu[i][0] <= mid:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        open_ = [e for e in stack if e[1] > mid]
        span = next((e[2] for e in open_ if e[2] in SPANS), None)
        inner = [e[2] for e in open_ if e[2] not in SPANS]
        label = (span.split(".")[1] if span else "between batches")
        if inner:
            label += f": {inner[0]}" + (f" > {inner[-1]}"
                                        if len(inner) > 1 else "")
        idle[label] += hi - lo
    by_name = collections.Counter()
    for name, us in kernel_us.items():
        by_name[short(name)] += us
    return Trace(
        window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6,
        kernel_s={n: us / 1e6 for n, us in kernel_us.items()},
        device_ops=[(n, us / 1e6) for n, us in by_name.most_common(TOP)],
        idle_gaps=[(n, us / 1e6) for n, us in idle.most_common(TOP)])
