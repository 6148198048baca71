"""The port's MicroBatcher (``subgc_tpu_torch/utils/microbatch.py``) held
to the twelve cases of ``tests/test_microbatch.py``: coalescing, leader
election under concurrency, error propagation to every caller, the
adaptive fill window, all-or-nothing admission under ``max_queue`` with
``QueueFull`` and ``shed_count``, and a bounded, live soak.  Every wait in
a case is bounded."""
import threading
import time

import pytest

from subgc_tpu_torch.utils.microbatch import MicroBatcher


def test_single_caller_full_batch_no_wait():
    calls = []
    mb = MicroBatcher(lambda xs: [x * 2 for x in (calls.append(list(xs)) or xs)],
                      max_batch=4, max_wait_ms=10_000.0)
    # a full batch must dispatch immediately, not wait out max_wait_ms
    assert mb.submit_many([1, 2, 3, 4]) == [2, 4, 6, 8]
    assert calls == [[1, 2, 3, 4]]
    assert mb.dispatch_count == 1


def test_underfull_dispatches_after_wait():
    mb = MicroBatcher(lambda xs: [x + 1 for x in xs], max_batch=8,
                      max_wait_ms=5.0)
    assert mb.submit(41) == 42
    assert mb.dispatch_count == 1


def test_concurrent_callers_coalesce():
    mb = MicroBatcher(lambda xs: [x * 10 for x in xs], max_batch=8,
                      max_wait_ms=200.0)
    n = 16
    barrier = threading.Barrier(n)
    results = [None] * n
    errors = []

    def worker(i):
        try:
            barrier.wait()
            results[i] = mb.submit(i)
        except Exception as e:       # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert results == [i * 10 for i in range(n)]
    # 16 items at max_batch 8 with a generous fill window: fewer dispatches
    # than callers proves coalescing (exactly 2 when timing cooperates;
    # loose bound tolerates single-core scheduling jitter)
    assert mb.dispatch_count <= 8


def test_oversubscribed_queue():
    """More queued items than max_batch: everyone still gets the right
    result via repeated leader elections."""
    mb = MicroBatcher(lambda xs: [x * 3 for x in xs], max_batch=2,
                      max_wait_ms=1.0)
    assert mb.submit_many(list(range(7))) == [i * 3 for i in range(7)]
    assert mb.dispatch_count == 4


def test_error_propagates_to_all_callers():
    def boom(xs):
        raise ValueError("kaput")
    mb = MicroBatcher(boom, max_batch=4, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="kaput"):
        mb.submit_many([1, 2])
    # batcher stays usable after a failed dispatch
    mb._run = lambda xs: xs
    assert mb.submit(5) == 5


def test_length_mismatch_detected():
    mb = MicroBatcher(lambda xs: xs[:-1] if len(xs) > 1 else xs,
                      max_batch=4, max_wait_ms=1.0)
    with pytest.raises(RuntimeError, match="returned 1 results for 2"):
        mb.submit_many([1, 2])


def test_adaptive_wait_policy():
    """AdaptiveWait: waits ~remaining_slots x mean_gap when traffic is
    steady, and the cap when filling within it is hopeless."""
    from subgc_tpu_torch.utils.microbatch import AdaptiveWait

    aw = AdaptiveWait(max_wait_ms=25.0, alpha=1.0, headroom=1.5)
    assert aw.wait_s(8, 8) == 0.0                       # already full
    assert aw.wait_s(1, 8) == 0.025                     # cold start: cap
    # steady 2 ms arrivals
    aw.mean_gap = 0.002
    est = aw.wait_s(4, 8)                               # 4 slots to fill
    assert abs(est - 1.5 * 4 * 0.002) < 1e-9
    # sparse traffic: estimate exceeds the cap -> wait exactly the cap
    # (waiting costs at most max_wait_ms against a much larger dispatch;
    # see AdaptiveWait.wait_s)
    aw.mean_gap = 0.1
    assert aw.wait_s(1, 8) == 0.025
    # EWMA updates from observed arrivals
    aw2 = AdaptiveWait(max_wait_ms=25.0, alpha=1.0)
    aw2.observe_arrivals(1)
    time.sleep(0.01)
    aw2.observe_arrivals(2)                             # 2 arrivals share gap
    assert aw2.mean_gap is not None and 0.003 < aw2.mean_gap < 0.05


def test_adaptive_batcher_end_to_end():
    seen = []
    mb = MicroBatcher(lambda xs: [x * 2 for x in seen.append(len(xs)) or xs],
                      max_batch=4, max_wait_ms=5.0, adaptive=True)
    # single caller, sparse traffic: dispatches should not wait the full cap
    t0 = time.monotonic()
    for i in range(6):
        assert mb.submit(i) == i * 2
    assert time.monotonic() - t0 < 2.0
    assert sum(seen) == 6


def test_max_queue_sheds_excess():
    """Admission control: submits that would push queued+in-flight past
    max_queue raise QueueFull instead of joining the line."""
    from subgc_tpu_torch.utils.microbatch import QueueFull
    release = threading.Event()

    def slow(xs):
        release.wait(5.0)
        return [x + 1 for x in xs]

    mb = MicroBatcher(slow, max_batch=2, max_wait_ms=1.0, max_queue=4)
    results, errors = [], []

    def worker(x):
        try:
            results.append(mb.submit(x))
        except QueueFull as e:
            errors.append(e)

    # 8 concurrent singles against capacity 4: the first dispatch (2 items)
    # goes in flight, 2 more queue, the rest must shed
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
        time.sleep(0.02)        # deterministic arrival order
    release.set()
    for t in ts:
        t.join()
    assert len(results) + len(errors) == 8
    assert errors, "nothing was shed at 2x capacity"
    assert results, "everything was shed"
    for e in errors:
        assert e.max_queue == 4 and e.load >= 2
    assert mb.shed_count == len(errors)


def test_max_queue_all_or_nothing():
    """A multi-item submit is admitted atomically: either every item rides
    or the whole request sheds (no partially-served request)."""
    from subgc_tpu_torch.utils.microbatch import QueueFull
    mb = MicroBatcher(lambda xs: [x * 2 for x in xs], max_batch=4,
                      max_wait_ms=1.0, max_queue=4)
    # fits exactly
    assert mb.submit_many([1, 2, 3, 4]) == [2, 4, 6, 8]
    # one larger than the cap -> immediate shed, nothing processed
    before = mb.item_count
    with pytest.raises(QueueFull):
        mb.submit_many([1, 2, 3, 4, 5])
    assert mb.item_count == before
    assert mb.shed_count == 5
    # the batcher still serves normally afterwards
    assert mb.submit(10) == 20


def test_max_queue_validation():
    with pytest.raises(ValueError, match="max_queue"):
        MicroBatcher(lambda xs: xs, max_batch=8, max_queue=4)


def test_overload_soak_bounded_and_live():
    """Soak at ~3x capacity: every request is either served correctly or
    shed with QueueFull, the instantaneous load never exceeds the cap, and
    the batcher keeps serving after the burst (no deadlock, no leak)."""
    from subgc_tpu_torch.utils.microbatch import QueueFull
    cap = 8
    observed = []

    def slowish(xs):
        observed.append(len(xs))
        time.sleep(0.01)
        return [x + 100 for x in xs]

    mb = MicroBatcher(slowish, max_batch=4, max_wait_ms=1.0, max_queue=cap)
    served, shed, wrong = [], [], []
    loads = []

    def client(i):
        for j in range(10):
            try:
                r = mb.submit(i * 100 + j)
                (served if r == i * 100 + j + 100 else wrong).append(r)
            except QueueFull:
                shed.append((i, j))
            loads.append(mb.load())

    ts = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not wrong
    assert len(served) + len(shed) == 120
    assert served, "soak shed everything"
    # load() measured between submits bounds queued + one in-flight batch
    assert max(loads) <= cap + mb._max
    # still alive after the storm
    assert mb.submit(7) == 107
