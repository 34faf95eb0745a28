"""Reduction of a profiler trace to the numbers the metric readers use.

Reads the ``.xplane.pb`` that ``jax.profiler`` writes, with
``jax.profiler.ProfileData`` alone.  What it relies on:

* device planes are named ``/device:GPU:<n>``; their lines named
  ``Stream #...`` hold one event per kernel or copy, on the same clock
  as the host events;
* a copy carries the stat ``memcpy_details`` (or is named
  ``Memcpy...``); every other device event is a kernel;
* the host plane ``/host:CPU`` holds the benchmark's spans: one
  ``bench.step`` per step (``StepTraceAnnotation``) and one
  ``bench.<call>`` per facade call; one ``PJRT_LoadedExecutable_Execute``
  per launch of a compiled XLA program; and the device allocator's
  ``MemoryAllocation`` / ``MemoryDeallocation`` events (allocator
  ``GPU_<n>_bfc``) with the bytes in use after each.
"""
from __future__ import annotations

import glob
import os
import re
import statistics
from collections import defaultdict
from dataclasses import dataclass, field

STEP = "bench.step"
EXECUTE = "PJRT_LoadedExecutable_Execute"
_ALLOC = ("MemoryAllocation", "MemoryDeallocation")
_DEVICE_ALLOCATOR = re.compile(r"^GPU_\d+_bfc$")


def union(intervals) -> float:
    """Total length covered by ``[(start, end), ...]``."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


@dataclass
class Device:
    kernels: list = field(default_factory=list)   # (start, end, name)
    copies: list = field(default_factory=list)    # (start, end, name)


@dataclass
class Reduction:
    """Times in nanoseconds on the trace's clock."""
    steps: list             # (start, end) of each traced step, in order
    devices: dict           # plane name -> Device
    spans: list             # (start, end, name) of the bench.<call> spans
    executions: list        # start of each program launch
    allocations: dict       # allocator -> [(time, bytes in use)]

    @property
    def window(self):
        return self.steps[0][0], self.steps[-1][1]

    @property
    def window_ns(self) -> float:
        lo, hi = self.window
        return hi - lo

    def _per_device(self, kind):
        lo, hi = self.window
        return [_clip([(s, e) for s, e, _ in getattr(d, kind)], lo, hi)
                for d in self.devices.values()]

    def busy_ns(self) -> float:
        """Union of kernels and copies in the window, averaged over the
        devices."""
        per = [union(k + c) for k, c in zip(self._per_device("kernels"),
                                            self._per_device("copies"))]
        return sum(per) / len(per) if per else 0.0

    def kernel_ns(self) -> float:
        per = [union(k) for k in self._per_device("kernels")]
        return sum(per) / len(per) if per else 0.0

    def copy_ns(self) -> float:
        per = [union(c) for c in self._per_device("copies")]
        return sum(per) / len(per) if per else 0.0

    def executions_per_step(self):
        """Program launches per traced step; None without launch events."""
        if not self.executions:
            return None
        n = sum(1 for t in self.executions
                if any(s <= t < e for s, e in self.steps))
        return n / len(self.steps)

    def transient_bytes(self):
        """Per step, the device memory in use above what was in use when
        the step began, at its highest; the median over steps and the
        largest over allocators.  None without allocator events."""
        best = None
        for events in self.allocations.values():
            events = sorted(events)
            per_step = []
            for s, e in self.steps:
                before = [b for t, b in events if t < s]
                inside = [b for t, b in events if s <= t < e]
                if before and inside:
                    per_step.append(max(0, max(inside) - before[-1]))
            if per_step:
                m = statistics.median(per_step)
                best = m if best is None else max(best, m)
        return best

    def top_ops(self, n=10) -> list:
        """The device operations that took most time, ``[[name, s]]``,
        summed over the window and averaged over the devices."""
        lo, hi = self.window
        tot = defaultdict(float)
        for d in self.devices.values():
            for s, e, name in d.kernels + d.copies:
                s, e = max(s, lo), min(e, hi)
                if e > s:
                    tot[name] += (e - s) / 1e9 / len(self.devices)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10) -> list:
        """Device idle time in the window by what the host was doing
        (the innermost ``bench.<call>`` span at the middle of each gap;
        ``bench.step`` between calls; ``between steps`` outside a step),
        summed, ``[[what, s]]``, averaged over the devices."""
        lo, hi = self.window
        tot = defaultdict(float)
        for d in self.devices.values():
            busy = merged(_clip([(s, e) for s, e, _ in d.kernels + d.copies],
                                lo, hi))
            edges = [lo] + [x for iv in busy for x in iv] + [hi]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e > s:
                    tot[self._host_at((s + e) / 2)] += (e - s) / 1e9 / len(self.devices)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t):
        inner = None
        for s, e, name in self.spans:
            if s <= t < e and (inner is None or s >= inner[0]):
                inner = (s, e, name)
        if inner:
            return inner[2]
        return STEP if any(s <= t < e for s, e in self.steps) else "between steps"


def find(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f"expected one trace under {trace_dir}, "
                           f"found {len(paths)}")
    return paths[0]


def reduce(path: str):
    """Reduce the trace at ``path``; None when it holds no step."""
    from jax.profiler import ProfileData

    prof = ProfileData.from_file(path)
    steps, spans, execs = [], [], []
    devices, allocs = {}, defaultdict(list)
    for plane in prof.planes:
        if plane.name.startswith("/device:GPU:"):
            dev = devices.setdefault(plane.name, Device())
            for line in plane.lines:
                if not line.name.startswith("Stream #"):
                    continue
                for ev in line.events:
                    s = ev.start_ns
                    e = s + ev.duration_ns
                    stats = dict(ev.stats)
                    if "memcpy_details" in stats or ev.name.startswith("Memcpy"):
                        dev.copies.append((s, e, ev.name))
                    else:
                        mod = stats.get("hlo_module")
                        dev.kernels.append(
                            (s, e, f"{mod}:{ev.name}" if mod else ev.name))
        elif plane.name == "/host:CPU":
            for line in plane.lines:
                for ev in line.events:
                    name = ev.name
                    if name == STEP:
                        steps.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    elif name.startswith("bench."):
                        spans.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                                      name))
                    elif name == EXECUTE:
                        execs.append(ev.start_ns)
                    elif name in _ALLOC:
                        st = dict(ev.stats)
                        alloc = st.get("allocator_name") or ""
                        if _DEVICE_ALLOCATOR.match(alloc):
                            allocs[alloc].append((ev.start_ns,
                                                  st.get("bytes_allocated", 0)))
    if not steps:
        return None
    return Reduction(sorted(steps), devices, spans, execs, dict(allocs))
