"""The port's worker pool (autocycler_tpu_torch/utils/pool.py), the two
ordered shapes the streamed grouping runs on: the serial writer lane keeps
submission order, bounds its depth and raises the first failure; the
read-ahead iterator keeps item order, runs serially at depth 1 and raises
a failure where the consumer reads it. Each case also runs the JAX
package's pool on the same jobs, which must give the same sequence."""

import threading
import time

import pytest

from autocycler_tpu.utils import pool as jax_pool
from autocycler_tpu_torch.utils import pool


def _lane_order(module, n: int, depth: int):
    lane = module.OrderedSubmitter(1, depth=depth)
    got, peak = [], []
    lock = threading.Lock()

    def job(i):
        time.sleep(0.002 if i % 3 == 0 else 0)   # jitter the fast ones
        with lock:
            got.append(i)

    for i in range(n):
        lane.submit(job, i)
        peak.append(len(lane._pending))
    lane.drain()
    return got, max(peak)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_ordered_submitter_preserves_order_and_bounds_depth(depth):
    got, peak = _lane_order(pool, 40, depth)
    assert got == list(range(40))
    assert peak <= depth
    assert _lane_order(jax_pool, 40, depth)[0] == got


def test_ordered_submitter_propagates_first_error():
    lane = pool.OrderedSubmitter(1, depth=4)
    ran = []

    def boom():
        raise OSError("disk gone")

    lane.submit(boom)
    lane.submit(lambda: ran.append(1))     # chained: sees the failure
    with pytest.raises(OSError, match="disk gone"):
        lane.drain()
    assert ran == []
    lane.submit(lambda: ran.append(2))     # a drained lane is reusable
    lane.drain()
    assert ran == [2]


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_prefetch_iter_keeps_order(depth):
    items = list(range(25))
    want = [x * x for x in items]
    assert list(pool.prefetch_iter(lambda x: x * x, items, 3,
                                   depth=depth)) == want
    assert list(jax_pool.prefetch_iter(lambda x: x * x, items, 3,
                                       depth=depth)) == want


def test_prefetch_iter_runs_ahead_and_serially_at_depth_one():
    started = []

    def note(x):
        started.append(x)
        return x

    it = pool.prefetch_iter(note, range(10), 4, depth=3)
    assert next(it) == 0
    time.sleep(0.05)
    assert sorted(started)[:3] == [0, 1, 2]      # two calls ran ahead
    assert list(it) == list(range(1, 10))
    started.clear()
    it = pool.prefetch_iter(note, range(10), 4, depth=1)
    assert next(it) == 0
    assert started == [0]                        # nothing ahead at depth 1


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetch_iter_raises_where_read(depth):
    def maybe_boom(x):
        if x == 7:
            raise ValueError("seven")
        return x

    got = []
    with pytest.raises(ValueError, match="seven"):
        for x in pool.prefetch_iter(maybe_boom, range(25), 3, depth=depth):
            got.append(x)
    assert got == list(range(7))


def test_get_executor_grows_and_is_shared():
    a = pool.get_executor(2)
    assert pool.get_executor(1) is a
    b = pool.get_executor(a._max_workers + 3)
    assert b._max_workers >= 5 and pool.get_executor(2) is b
    assert b.submit(lambda: 41 + 1).result(timeout=10) == 42
