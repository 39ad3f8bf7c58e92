"""Spans at the layer boundaries of the port's entry loops, on the clock of
torch.profiler's records.

A span records its name, its start and end in ns, its own id, its parent's
id, the step id of the request it belongs to (every span of one frame,
``render`` call or train step shares it) and the counts its site took at
the same boundary (``Span.count``). Spans nest: a span opened inside
another is its child and takes its step id; a span with no parent starts a
request, and its id is the request's step id, unless the site names the
step (``span(name, step=...)``: the viewer's image joins its frame).

Spans record only while a torch.profiler session runs
(``torch.autograd.profiler._is_profiler_enabled``): an operator's own
profile, or the benchmark's traced window. With no profiler a span site
reads that flag and gets the shared ``NULL`` context: no clock read, no
allocation, no host sync.

Times are ``time.time_ns()``: Unix-epoch ns, the clock kineto stamps its
records with (host and device records alike, the device's mapped to the
host's), so a span and the kernels launched inside it lie on one axis
(``chip_smoke.py`` phase telemetry checks that on the card).

``spans()`` returns the newest ``LIMIT`` spans in the order they opened;
``clear()`` empties the buffer. Nothing is written to a file.

The sites and the counts they take (PERF.md section 3):

- ``render`` (``integrator.render.render``): the call, with ``samples``
  and ``adaptive`` (0 or 1);
- ``render.count``: the adaptive loop's read of the active count, its one
  host sync a step;
- ``render.candidates``: the candidate gather on entering tail mode;
- ``render.step`` and ``render.tail``: one step, with ``lanes`` (the lanes
  launched: every pixel for a full step, the bucket for a tail step) and
  ``active`` (the lanes that take a sample: the count that sized a full
  step, the count a tail step returns);
- ``graph.replay`` (``GraphStep``): the copy-in, the replay and the
  output copies of a graph step;
- ``train.step`` (``dist.sharding.sharded_train_step_fn``) and in it
  ``train.forward`` (copy-in and the forward replay), ``train.loss`` (the
  eager loss and its gradient), ``train.backward`` (the backward replay
  and the gradients' copies), ``train.all_reduce`` and ``train.update``
  (the eager SGD step);
- ``viewer.step`` (input, key words, the step) and ``viewer.image``
  (resolve, tonemap, the copy to the host) of ``viewer.InteractiveSession``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Optional

from torch.autograd import profiler as _profiler

LIMIT = 1 << 17


@dataclasses.dataclass(eq=False)
class Span:
    """One span; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    id: int
    parent: Optional[int]
    step: int
    counts: dict
    _stack: list = dataclasses.field(repr=False)

    def count(self, key: str, value) -> None:
        """Records ``value`` under ``key``, taken at this span's boundary."""
        self.counts[key] = value

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, kind, value, tb) -> None:
        self.end_ns = time.time_ns()
        self._stack.pop()


class _Null:
    """The context a span site gets when no profiler runs: it records
    nothing."""

    __slots__ = ()
    step = None

    def count(self, key: str, value) -> None:
        pass

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, kind, value, tb) -> None:
        pass


NULL = _Null()


class _Recorder:
    """The buffer of spans, their ids, and each thread's open spans."""

    def __init__(self, limit: int = LIMIT) -> None:
        self.spans = collections.deque(maxlen=limit)
        self.ids = itertools.count()
        self.local = threading.local()

    def open(self, name: str, step: Optional[int]) -> Span:
        stack = self.local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        sid = next(self.ids)
        if step is None:
            step = sid if parent is None else parent.step
        s = Span(name, time.time_ns(), None, sid, None if parent is None else parent.id, step,
                 {}, stack)
        stack.append(s)
        self.spans.append(s)
        return s


_RECORDER = _Recorder()


def span(name: str, step: Optional[int] = None):
    """The span ``name`` over a ``with`` block while a profiler runs, else
    ``NULL``. ``step``: the step id of the request it joins (default: its
    parent's, or a new one)."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return _RECORDER.open(name, step)


def spans() -> list:
    """The recorded spans, oldest first."""
    return list(_RECORDER.spans)


def clear() -> None:
    """Empties the buffer (open spans still close)."""
    _RECORDER.spans.clear()
