"""The device trace of a run: a torch.profiler window and what it holds.

``cuda_profile`` and ``device_records`` are a frozen copy of the port's
``tools/profiling.py`` (which says why every window opens with idle pads
and 2,000 one-thread filler kernels: kineto drops a window's first
records, and keeps only records whose mapped times fall inside it).
``summarize`` reduces the records to what the per-layer metrics and the
result's ``device`` and ``breakdown`` read.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import sys
import time

import torch

PAD_S = 0.05
FILLERS, FILLER_CYCLES = 2000, 100
TOP = 10


def cuda_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


@functools.cache
def filler_name() -> str:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(FILLERS):
            torch.cuda._sleep(FILLER_CYCLES)
        torch.cuda.synchronize()
    names = collections.Counter(e.name() for e in cuda_events(prof))
    if len(names) != 1:
        raise RuntimeError(f"a profile of the fillers alone holds {dict(names)}")
    return next(iter(names))


@contextlib.contextmanager
def cuda_profile():
    """torch.profiler over the block, CUDA activity only, padded with idle
    time and opened by filler kernels; raises if it kept none of them."""
    from torch.profiler import ProfilerActivity, profile

    filler = filler_name()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        for _ in range(FILLERS):
            torch.cuda._sleep(FILLER_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    kept = sum(e.name() == filler for e in cuda_events(prof))
    if kept < FILLERS:
        print(f"profiler: the window dropped its first {FILLERS - kept} records (fillers)",
              file=sys.stderr)
    if kept == 0:
        raise RuntimeError(f"the profiler dropped all {FILLERS} fillers that open its window")


def device_records(prof) -> list:
    """[(name, start ns, duration ns)] of the window but its fillers, in
    start order."""
    filler = filler_name()
    return sorted(((e.name(), e.start_ns(), e.duration_ns()) for e in cuda_events(prof)
                   if e.name() != filler), key=lambda r: r[1])


@dataclasses.dataclass
class Summary:
    """A traced window: its records, the union of their intervals
    (``busy_s``), their span (``window_s``), and what the harness counted
    in it: ``steps`` (frames, render steps, a rank's samples or train
    steps), ``rays`` (pixel-samples x bounces x 2), ``kind`` ("render" or
    "train") and ``units`` (frames, calls, images or train steps)."""

    records: list
    busy_s: float
    window_s: float
    steps: int
    rays: float
    kind: str
    units: int = 0

    def seconds_of(self, *parts: str) -> float:
        """Device seconds of the records whose name holds one of ``parts``."""
        return sum(d for n, _, d in self.records if any(p in n for p in parts)) * 1e-9

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the records on either side."""
        by_name = collections.Counter()
        for name, _, dur in self.records:
            by_name[_short(name)] += dur
        gaps = []
        end, prev = None, None
        for name, start, dur in self.records:
            if end is not None and start > end:
                gaps.append((start - end, f"{_short(prev)} -> {_short(name)}"))
            if end is None or start + dur > end:
                end, prev = start + dur, name
        gaps.sort(reverse=True)
        return {"device_ops": [[n, ns * 1e-9] for n, ns in by_name.most_common(TOP)],
                "idle_gaps": [[label, ns * 1e-9] for ns, label in gaps[:TOP]]}


def _short(name: str) -> str:
    """A kernel's name without its namespace's "(anonymous namespace)::"
    and its parameter list, at most 120 characters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()[:120]


def summarize(records: list, steps: int, rays: float, kind: str, units: int = 0) -> Summary:
    if not records:
        raise RuntimeError("the traced window holds no device record")
    busy = 0
    end = None
    for _, start, dur in records:
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    span = max(s + d for _, s, d in records) - records[0][1]
    return Summary(records, busy * 1e-9, span * 1e-9, steps, rays, kind, units)
