"""The process-wide worker pool and the ordered shapes run on it, as the
JAX package's utils/pool.py has them: an order-preserving map (compress's
assembly loads, trim's per-sequence work), a depth-bounded serial lane (the
streamed grouping's pass-1 disk appends) and a read-ahead iterator (its
pass-2 bin reads). Each keeps its input order, so what it produces is the
same at every depth and worker count. Each runs its tasks under the
submitting thread's bound trace run and QC scope (:func:`_context_wrapper`),
so a serve job's pooled work lands in that job's run dir."""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

_lock = threading.Lock()
_executor = None
_executor_width = 0


def _context_wrapper() -> Optional[Callable]:
    """Capture the submitting thread's observability context, its bound
    trace run and QC scopes, as a ``wrap(fn)`` decorator replayed inside
    pool threads, so spans, QC and ledger entries recorded by pooled work
    belong to the job that submitted it (the serve scheduler runs N jobs
    concurrently on the one shared executor). None when there is nothing
    to carry (the CLI's path: no per-task cost)."""
    from ..obs import qc, trace
    run = trace.current_run()
    scopes = qc.scope_context()
    if run is None and scopes is None:
        return None

    def wrap(fn: Callable) -> Callable:
        def call(*args, **kwargs):
            with contextlib.ExitStack() as ctx:
                if run is not None:
                    ctx.enter_context(trace.bind_run(run))
                if scopes is not None:
                    ctx.enter_context(qc.restore_scope(scopes))
                return fn(*args, **kwargs)
        return call

    return wrap


def get_executor(workers: int) -> ThreadPoolExecutor:
    """The shared ``ThreadPoolExecutor``, grown to at least ``workers``
    threads. Callers must not shut it down."""
    global _executor, _executor_width
    workers = max(1, int(workers))
    with _lock:
        if _executor is None or _executor_width < workers:
            # growing replaces the executor; the old one finishes its work
            old = _executor
            _executor = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="autocycler-pool")
            _executor_width = workers
            if old is not None:
                old.shutdown(wait=False)
        return _executor


class OrderedSubmitter:
    """A serial lane on the shared executor: jobs run strictly in submission
    order (each waits on its predecessor's future first), with at most
    ``depth`` futures outstanding, ``submit`` blocking on the oldest when
    the lane is full. ``drain`` re-raises the first job's exception."""

    def __init__(self, workers: int, depth: int = 2):
        self._workers = max(1, int(workers))
        self._depth = max(1, int(depth))
        self._pending: deque = deque()
        self._prev = None

    def submit(self, fn: Callable, *args) -> None:
        prev = self._prev
        wrap = _context_wrapper()
        if wrap is not None:
            fn = wrap(fn)

        def job():
            if prev is not None:
                prev.result()       # keep the order; a failure propagates
            return fn(*args)

        while len(self._pending) >= self._depth:
            self._pending.popleft().result()
        # fetched per submit: growing the pool replaces the executor
        fut = get_executor(self._workers).submit(job)
        self._prev = fut
        self._pending.append(fut)

    def drain(self) -> None:
        """Waits for every submitted job; raises the first job exception."""
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._pending.clear()
            self._prev = None


def prefetch_iter(fn: Callable, items: Sequence, workers: int,
                  depth: int = 2) -> Iterator:
    """Yields ``fn(item)`` for each item in order, with up to ``depth``
    calls in flight ahead of the consumer on the shared executor;
    ``depth <= 1`` is a plain serial generator."""
    items = list(items)
    if depth <= 1 or len(items) <= 1:
        for x in items:
            yield fn(x)
        return
    wrap = _context_wrapper()
    if wrap is not None:
        fn = wrap(fn)
    pending: deque = deque()
    i = 0
    try:
        while pending or i < len(items):
            while i < len(items) and len(pending) < depth:
                pending.append(get_executor(workers).submit(fn, items[i]))
                i += 1
            yield pending.popleft().result()
    finally:
        for fut in pending:
            fut.cancel()


def pool_map(fn: Callable, items: Iterable, workers: int) -> List:
    """Order-preserving map over ``items`` on the shared executor; a plain
    serial map when one worker (or one item) makes the pool pointless."""
    items = list(items)
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    wrap = _context_wrapper()
    if wrap is not None:
        fn = wrap(fn)
    return list(get_executor(workers).map(fn, items))
