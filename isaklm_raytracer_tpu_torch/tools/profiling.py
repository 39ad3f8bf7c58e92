"""torch.profiler windows whose CUDA records can be counted.

``cuda_profile`` opens a window of CUDA activity with idle time at both
ends and filler kernels ahead of the block; ``device_records`` reads the
block's records without the fillers. ``chip_smoke.py`` and
``tools/compare_render.py`` count kernels through these two.
``idle_gaps`` and ``idle_by_span`` split a window's idle time by the
program's spans (``telemetry``) open at the launches that ended each
gap. The module
imports torch and the standard library only, so a script can load it from
its file beside another checkout's package.

Why the pads and fillers: kineto keeps the records whose device times,
mapped to the host's clock, fall inside the window, and the mapping is off
by up to a few tenths of a millisecond on an H100, so without PAD_S of
idle time the kernels of a step that ends just before the window closes
were lost (a whole graph replay in 5 of 20 blocks of four steps; none of
20 with the pad). kineto also drops the FIRST records of a window, however
long the idle pad, in a number that grows as the process runs: none early
on, the block's first 3-10 kernels after three profiles of a million
records each (a pad of 0.5 s lost the same), up to 40 late in
``chip_smoke.py``; a profile of one kernel, taken after a few hundred
thousand unprofiled launches, lost it. So every window opens with FILLERS
launches of a one-thread spin kernel (``torch.cuda._sleep``), which no
count reads; a window that kept none of them may have lost the block's own
records, and raises.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import time

import torch

PAD_S = 0.05
FILLERS, FILLER_CYCLES = 2000, 100


def cuda_events(prof):
    """The CUDA records (kernels, copies, fills) of a torch.profiler run,
    as kineto's events."""
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]


@functools.cache
def filler_name() -> str:
    """The name torch.profiler gives the filler kernel in this process: the
    name of the records of a profile of FILLERS fillers alone (which may
    lose its first records too)."""
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
def cuda_profile(log=print):
    """torch.profiler over the block, CUDA activity only, with PAD_S of
    idle time before the block and after its last kernel, and FILLERS
    filler kernels ahead of the block (which ``device_records`` leaves
    out). Raises if the profile kept none of them; ``log`` is told how
    many it dropped."""
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
        log(f"profiler: the window dropped its first {FILLERS - kept} records (fillers)")
    if kept == 0:
        raise RuntimeError(f"the profiler dropped all {FILLERS} fillers that open its "
                           "window: the block's own first records may be lost")


def device_records(prof):
    """The CUDA records of a ``cuda_profile`` window but its fillers:
    [(name, start ns, duration ns)]."""
    filler = filler_name()
    return [(e.name(), e.start_ns(), e.duration_ns()) for e in cuda_events(prof)
            if e.name() != filler]


def idle_gaps(prof) -> list:
    """The idle gaps of a ``cuda_profile`` window but its fillers (from its
    first record's start to its last record's end): [(idle ns, the host's
    ns of the launch of the record that ends the gap or None, that
    record's device start ns)], in order. A gap's length is a difference
    of device times, and the launch's time is the host's runtime call of
    the same correlation id (a kernel, graph or copy launch) on the host's
    clock: neither depends on how kineto maps the device's clock onto the
    host's, which drifts within a window (PERF.md)."""
    from torch.autograd import DeviceType

    filler = filler_name()
    launched = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("cuda"):
            launched.setdefault(e.correlation_id(), e.start_ns())
    records = sorted((e.start_ns(), e.duration_ns(), e.correlation_id())
                     for e in cuda_events(prof) if e.name() != filler)
    gaps, end = [], None
    for start, dur, corr in records:
        if end is not None and start > end:
            gaps.append((start - end, launched.get(corr), start))
        if end is None or start + dur > end:
            end = start + dur
    return gaps


def idle_by_span(gaps, spans) -> dict:
    """The idle ns of ``gaps`` (``idle_gaps``) by the innermost of
    ``spans`` (``telemetry.Span``) open when the host launched the work
    that ended each gap, the work the card waited for: {span name: ns},
    and under None the gaps ended by a launch under no span or not in the
    profile. Of two open spans the one opened later is the innermost."""
    events = sorted(e for s in spans if s.end_ns is not None
                    for e in ((s.start_ns, 1, s.id, s.name), (s.end_ns, 0, s.id, s.name)))
    times, innermost, opened = [], [], {}
    for t, kind, sid, name in events:
        if kind:
            opened[sid] = name
        else:
            del opened[sid]
        times.append(t)
        innermost.append(opened[max(opened)] if opened else None)
    split = collections.Counter()
    for ns, launch, _ in gaps:
        i = -1 if launch is None else bisect.bisect_right(times, launch) - 1
        split[innermost[i] if i >= 0 else None] += ns
    return dict(split)
