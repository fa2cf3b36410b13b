"""Spans and counters of the port, on the host clock and in the device trace.

A span times one stage of the work where it happens::

    with trace.span('scatter') as sp:
        ...
    sp.elapsed            # seconds, time.perf_counter
    sp.seconds['scatter'] # the same; sp.seconds also sums its descendants

Spans nest per thread.  Each closed span adds its duration, under its name,
to the ``seconds`` of every span still open around it on its thread, and
``count(name, n)`` adds to their ``counts``: so the outermost span of a fit
(``Evaluation.fit``'s ``fit``) or of a subject (the sweep's ``subject``)
holds that fit's or subject's record, from which the facade's and the tile
driver's timer dicts are built.  A span with no parent on its thread starts
a new request id (``req``), which its descendants share.

Tracing is on while a ``torch.profiler`` profile is active (the facade's
``profile_dir`` config, a benchmark's traced window) or after
:func:`enable`.  Then each span also

- opens ``torch.profiler.record_function('amico.' + name)``, so that the
  span sits on the device trace's clock and names the device's idle gaps
  (a profiler records the ranges of the thread that started it only);
- appends a record to a bounded in-memory log: ``name``, ``t0``, ``t1``
  (perf_counter seconds), ``id``, ``parent`` (the enclosing span's ``id``),
  ``req``, ``thread``, ``attrs`` and ``counts``.  :func:`spans` reads it;
  :func:`dropped` says whether the bound lost records, so that a reader
  can refuse a window that overflowed.

Tracing off, a span costs two clock reads and a few dict additions: no
profiler op, no log entry, no device work.  Device-side counts
(:func:`count_on_device`) are kept only while tracing is on.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _autograd_profiler

# a 30 s window of the fastest re-fit cell holds ~650 fits of ~25 spans
LOG_BOUND = 65536

_ids = itertools.count(1)


class _Local(threading.local):
    """Each thread's open spans, the request id its outermost span takes
    (None: a fresh one) and its device counts not yet read."""

    def __init__(self):
        self.stack: list = []
        self.req: int | None = None
        self.pending: list = []


_local = _Local()


class _Log:
    """The bounded log of closed spans, shared by every thread."""

    def __init__(self, bound: int = LOG_BOUND):
        self.lock = threading.Lock()
        self.records: deque = deque(maxlen=bound)
        self.dropped = 0
        self.dropped_until = float('-inf')   # latest t1 among the dropped

    def append(self, rec: dict) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                old = self.records[0]
                self.dropped += 1
                self.dropped_until = max(self.dropped_until, old['t1'])
            self.records.append(rec)


_log = _Log()
_enabled = False


def enable() -> None:
    """Turn tracing on without a profiler: spans go to the log."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Undo :func:`enable` (a running profiler still turns tracing on)."""
    global _enabled
    _enabled = False


def profiling() -> bool:
    """Whether a ``torch.profiler`` profile is active in this process
    (``torch.profiler.profile`` sets this flag while it records)."""
    return bool(_autograd_profiler._is_profiler_enabled)


def on() -> bool:
    """Whether tracing is on: after :func:`enable`, or while profiling."""
    return _enabled or profiling()


def clear(bound: int = LOG_BOUND) -> None:
    """Empty the log and its drop count (a new bound takes effect)."""
    global _log
    _log = _Log(bound)


def spans(t0: float | None = None, t1: float | None = None,
          name: str | None = None) -> list[dict]:
    """The logged spans that started within [t0, t1] (perf_counter
    seconds; None leaves that end open), of ``name`` if given."""
    lo = float('-inf') if t0 is None else t0
    hi = float('inf') if t1 is None else t1
    with _log.lock:
        recs = list(_log.records)
    return [r for r in recs if lo <= r['t0'] <= hi
            and (name is None or r['name'] == name)]


def dropped(t0: float | None = None) -> int:
    """How many spans the log's bound dropped since it was last cleared;
    with ``t0``, 0 unless one of them ended at or after ``t0`` (the log
    drops its oldest records first)."""
    with _log.lock:
        n, until = _log.dropped, _log.dropped_until
    return n if n and (t0 is None or until >= t0) else 0


def new_req() -> int:
    """A fresh request id, for spans that start on another thread."""
    return next(_ids)


class request:
    """Within the block, a span opened with no parent on this thread takes
    the request id ``req`` (None: a fresh one): the sweep's prefetch thread
    loads a subject under the id of that subject's later spans."""

    def __init__(self, req: int | None):
        self.req = req

    def __enter__(self):
        self.prev = _local.req
        _local.req = self.req

    def __exit__(self, *exc):
        _local.req = self.prev


class span:
    """Time the block as the span ``name``; ``attrs`` go into its log
    record (more may be set on ``.attrs`` inside the block).  The span's
    own duration is ``elapsed`` once it has closed; ``seconds`` and
    ``counts`` sum those of its descendants by name, its own included."""

    __slots__ = ('name', 'attrs', 'req', 'id', 'parent', 'seconds',
                 'counts', 't0', 't1', '_range', '_logged')

    def __init__(self, name: str, req: int | None = None, **attrs):
        self.name = name
        self.attrs = attrs
        self.req = req
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.t1 = None

    def __enter__(self) -> 'span':
        st = _local.stack
        parent = self.parent = st[-1] if st else None
        if parent is not None:
            self.req = parent.req
        elif self.req is None:
            self.req = _local.req or next(_ids)
        profiled = _autograd_profiler._is_profiler_enabled
        self._logged = _enabled or profiled
        self._range = self.id = None
        if self._logged:
            self.id = next(_ids)
            if profiled:
                self._range = torch.profiler.record_function(
                    'amico.' + self.name)
                self._range.__enter__()
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = self.t1 = time.perf_counter()
        dt = t1 - self.t0
        st = _local.stack
        if len(st) == 1 and _local.pending:
            settle()
        st.pop()
        name = self.name
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        for fr in st:
            fr.seconds[name] = fr.seconds.get(name, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self._logged:
            p = self.parent
            _log.append({'name': name, 't0': self.t0, 't1': t1,
                         'id': self.id,
                         'parent': None if p is None else p.id,
                         'req': self.req,
                         'thread': threading.current_thread().name,
                         'attrs': self.attrs, 'counts': dict(self.counts)})

    @property
    def elapsed(self) -> float:
        """Seconds from the span's start to its end (or to now, open)."""
        t1 = time.perf_counter() if self.t1 is None else self.t1
        return t1 - self.t0


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of every span open on this
    thread (none open: nothing)."""
    for fr in _local.stack:
        fr.counts[name] = fr.counts.get(name, 0) + int(n)


def count_on_device(name: str, value: torch.Tensor) -> None:
    """While tracing is on, keep a device scalar to be added to the
    counter ``name`` by :func:`settle`, which reads it after the device is
    synchronised; tracing off, nothing is kept."""
    if on():
        _local.pending.append((name, value))


def settle() -> None:
    """Read the device counts kept on this thread into :func:`count`.
    Call it once the device work that computed them is complete (the tile
    driver does after its synchronise); the outermost span's close calls it
    too, for counts nobody settled."""
    pending = _local.pending
    if not pending:
        return
    _local.pending = []
    groups: dict[tuple, list] = {}
    for name, v in pending:
        groups.setdefault((name, v.device), []).append(
            v.reshape(()).to(torch.int64))
    for (name, _), vals in groups.items():
        count(name, int(torch.stack(vals).sum()))
