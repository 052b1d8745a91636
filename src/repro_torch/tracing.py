"""Spans inside the port: named intervals of host time, and of device
time where CUDA is in use, each with the span that caused it.

    from repro_torch import tracing

    with tracing.span("attn.forward", B=2, S=4096):
        ...

Spans record only while torch's profiler runs, and never while the
current stream captures a CUDA graph.  While on, a span also opens
``torch.profiler.record_function(name)``, which puts it in the
profiler's trace on the kernels' clock, and records a pair of timing
CUDA events on the current stream at entry and exit (when CUDA is
initialised).  The events are resolved into device time only when the
records are read.  While off, ``span`` costs one check and returns a
shared null context: it records nothing and creates no event.

A record (``Record``) holds the name, its id, its parent — the innermost
span open on the same thread or, for a thread with none open, the
innermost span open on any thread at its start, so that the spans
autograd runs on its backward thread hang under the step's
``train.backward`` — the step (the id of its outermost span: every span
of one ``train.step`` shares it), the thread, host start and end
(``time.perf_counter`` seconds), the attrs, and device seconds (None
without CUDA).  Records stay in memory, at most ``CAP`` of them; a span
past the cap records nothing and counts in ``dropped()``.  ``counts()``
gives each name's calls while on, dropped ones included.

The recorder is the process's, and its records span every profiler
session since the last ``reset()``: a caller that reads the spans of one
window resets where the window opens.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

CAP = 1 << 16
NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class Record:
    name: str
    id: int
    parent: Optional[int]
    step: int
    thread: int
    attrs: dict
    host_start: float
    host_end: float = 0.0
    device_s: Optional[float] = None
    events: Optional[tuple] = field(default=None, repr=False)

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


class _Span:
    """One open span: a record, its profiler range and its events."""
    __slots__ = ("rec", "_owner", "_range")

    def __init__(self, rec: Record, owner: "Recorder"):
        self.rec, self._owner, self._range = rec, owner, None

    def __enter__(self) -> Record:
        self._range = torch.profiler.record_function(self.rec.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            self.rec.events = ev
        self.rec.host_start = time.perf_counter()
        return self.rec

    def __exit__(self, *exc) -> None:
        self.rec.host_end = time.perf_counter()
        if self.rec.events is not None:
            self.rec.events[1].record()
        self._range.__exit__(*exc)
        self._owner._close(self)


class Recorder:
    """The spans of one process: the open ones of every thread, the
    closed records (at most ``cap``) and each name's calls."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._open: List[_Span] = []      # every thread's, in opening order
        self._records: List[Record] = []
        self._kept = 0
        self._counts: Dict[str, int] = {}
        self._dropped = 0

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, attrs: dict):
        if _capturing():
            return NULL
        stack = self._stack()
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
            if self._kept >= self.cap:
                self._dropped += 1
                return NULL
            self._kept += 1
            up = stack[-1] if stack else (self._open[-1] if self._open
                                          else None)
            i = next(self._ids)
            rec = Record(name, i, None if up is None else up.rec.id,
                         i if up is None else up.rec.step,
                         threading.get_ident(), attrs, 0.0)
            s = _Span(rec, self)
            self._open.append(s)
        stack.append(s)
        return s

    def _close(self, s: _Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        else:
            stack.remove(s)
        with self._lock:
            self._open.remove(s)
            self._records.append(s.rec)

    def records(self) -> List[Record]:
        """The closed records, in closing order, with device time
        resolved (this waits for each span's end event)."""
        with self._lock:
            out = list(self._records)
        for r in out:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                r.device_s = start.elapsed_time(end) * 1e-3
                r.events = None
        return out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._counts.clear()
            self._kept = self._dropped = 0


RECORDER = Recorder()


def enabled() -> bool:
    """Whether a span opened now would record."""
    return bool(_profiling()) and not _capturing()


def span(name: str, **attrs):
    """A context manager that records one span while the profiler runs
    (the module's docstring); the shared ``NULL`` while it does not."""
    if not _profiling():
        return NULL
    return RECORDER.span(name, attrs)


def records() -> List[Record]:
    return RECORDER.records()


def counts() -> Dict[str, int]:
    return RECORDER.counts()


def dropped() -> int:
    return RECORDER.dropped()


def reset() -> None:
    RECORDER.reset()
