"""Device-idle time under the program's spans, in ms a frame of a traced
viewer window: the window's idle gaps (its span less the union of its
records' intervals, as ``device_idle_pct.render`` takes them) where they
fall inside the union of the program's spans
(``isaklm_raytracer_tpu_torch.telemetry.spans()``) clipped to the window
(first record's start to last record's end), over the window's frames.
Idle time under no span is the caller's: the harness's own loop. None
where the window holds no span (a program without spans). It moves
``frame_ms_p95``.

``host_idle_ms_per_step.adaptive`` and ``.train`` load this file for
``host_idle_ns``."""


def window_spans(summary):
    """[[start, end]] ns: the union of the program's spans clipped to the
    window, in order; None where none overlaps it."""
    try:
        from isaklm_raytracer_tpu_torch import telemetry
    except ImportError:
        return None
    lo = summary.records[0][1]
    hi = max(s + d for _, s, d in summary.records)
    cut = sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in telemetry.spans()
                 if s.end_ns is not None and s.start_ns < hi and s.end_ns > lo)
    if not cut:
        return None
    union = [list(cut[0])]
    for start, end in cut[1:]:
        if start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], end)
        else:
            union.append([start, end])
    return union


def idle_gaps(records):
    """[(start, end)] ns of the gaps between the union of the records'
    intervals (records in start order)."""
    gaps, end = [], None
    for _, start, dur in records:
        if end is not None and start > end:
            gaps.append((end, start))
        if end is None or start + dur > end:
            end = start + dur
    return gaps


def host_idle_ns(summary):
    """The window's idle ns under the union of the program's spans; None
    where the window holds no span."""
    spans = window_spans(summary)
    if spans is None:
        return None
    total, i = 0, 0
    for start, end in idle_gaps(summary.records):
        while i < len(spans) and spans[i][1] <= start:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < end:
            total += min(end, spans[j][1]) - max(start, spans[j][0])
            j += 1
    return total


def read(summary):
    if summary.kind != "render" or summary.steps <= 0 or not summary.records:
        return None
    ns = host_idle_ns(summary)
    return None if ns is None else ns * 1e-6 / summary.steps
