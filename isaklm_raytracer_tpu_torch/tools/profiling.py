"""torch.profiler windows whose CUDA records can be counted.

``cuda_profile`` opens a window of CUDA activity with idle time at both
ends and filler kernels ahead of the block; ``device_records`` reads the
block's records without the fillers. ``chip_smoke.py`` and
``tools/compare_render.py`` count kernels through these two. The module
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
