"""Deadline-bounded device interaction: the fetch barrier's watchdog.

A trimmed copy of ``karpenter_core_tpu/utils/watchdog.py``.  A device that
goes quiet hangs its caller instead of raising; the pipelined tick
(``utils/pipeline.py``) keeps in-flight state (deferred ticks, carries freed
in place, fetch tickets) that one silent copy would pin for good.  This
module turns "the device went quiet" into a bounded ``SolveTimeout``:

  deadlines   per ``(site, key)``: an EWMA of observed warm latencies times
              a margin, clamped to [floor, ceiling]; a key not yet seen
              twice gets the cold budget (floor × cold_mult, clamped).  The
              first completion of a key only marks it seen (it pays the
              first-use costs).  Knobs, read per call:

                KC_WATCHDOG=0           off: calls run inline, no deadline
                KC_WATCHDOG_FLOOR_S     min deadline (default 10)
                KC_WATCHDOG_CEILING_S   max deadline (default 120)
                KC_WATCHDOG_MARGIN      EWMA multiplier (default 8)
                KC_WATCHDOG_COLD_MULT   floor multiplier for cold keys
                                        (default 120: cold = ceiling)

  run         ``run(site, fn, *args, key=)`` runs a blocking host call on a
              reusable worker thread under the deadline; on overrun the
              worker is abandoned (it retires by itself if the call ever
              returns) and ``SolveTimeout`` is raised.

The fetch barrier (``pipeline.FetchTicket.wait``) does not block a thread:
it polls its CUDA event against ``deadline_for`` and reports through
``observe`` / ``record_timeout``.

Left out, for a later slice (ROADMAP 1.5): ``BackendQuarantine`` and its
canary, the ``solver.hang`` chaos point, the timeout and headroom metrics
and the tracing event.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional


class SolveTimeout(RuntimeError):
    """A monitored device interaction overran its watchdog deadline.  A
    RuntimeError, as every backend fault the callers already handle."""

    def __init__(self, site: str, deadline_s: float, key=None) -> None:
        super().__init__(
            f"watchdog: {site} exceeded its {deadline_s:.2f}s deadline "
            f"(key={key!r}); the stuck call was abandoned"
        )
        self.site = site
        self.deadline_s = deadline_s
        self.key = key


def watchdog_enabled() -> bool:
    """KC_WATCHDOG=0 runs monitored calls inline with no deadline."""
    return os.environ.get("KC_WATCHDOG", "1") != "0"


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def floor_s() -> float:
    return max(_env_f("KC_WATCHDOG_FLOOR_S", 10.0), 0.001)


def ceiling_s() -> float:
    return max(_env_f("KC_WATCHDOG_CEILING_S", 120.0), floor_s())


def margin() -> float:
    return max(_env_f("KC_WATCHDOG_MARGIN", 8.0), 1.0)


def cold_mult() -> float:
    return max(_env_f("KC_WATCHDOG_COLD_MULT", 120.0), 1.0)


_EWMA_ALPHA = 0.3

_lock = threading.Lock()
# (site, key) -> EWMA of warm latencies; a key's first completion only marks
# it seen, the EWMA seeds at the second
_ewma: Dict[tuple, float] = {}
_seen: set = set()
_timeouts: Dict[str, int] = {}
_last_headroom: Dict[str, float] = {}


def reset_stats() -> None:
    """Forget every observation, deadline and counter."""
    with _lock:
        _ewma.clear()
        _seen.clear()
        _timeouts.clear()
        _last_headroom.clear()


def stats() -> Dict[str, object]:
    """Per-site timeout counts and the last deadline-headroom ratio."""
    with _lock:
        return {
            "timeouts": dict(_timeouts),
            "headroom": {k: round(v, 4) for k, v in _last_headroom.items()},
        }


def deadline_for(site: str, key=None) -> float:
    """EWMA × margin clamped to [floor, ceiling] once the key is warm; the
    cold budget (floor × cold_mult, clamped) before that."""
    lo, hi = floor_s(), ceiling_s()
    with _lock:
        ewma = _ewma.get((site, key))
    if ewma is None:
        return min(max(lo * cold_mult(), lo), hi)
    return min(max(ewma * margin(), lo), hi)


def observe(site: str, key, elapsed_s: float, deadline_s: float) -> None:
    """Fold one completed call's latency into its key's EWMA."""
    with _lock:
        k = (site, key)
        if k not in _seen:
            _seen.add(k)
        else:
            prev = _ewma.get(k)
            _ewma[k] = elapsed_s if prev is None else prev + _EWMA_ALPHA * (elapsed_s - prev)
        _last_headroom[site] = (
            max(1.0 - elapsed_s / deadline_s, 0.0) if deadline_s > 0 else 0.0
        )


def record_timeout(site: str) -> None:
    with _lock:
        _timeouts[site] = _timeouts.get(site, 0) + 1
        _last_headroom[site] = 0.0


# -- the worker pool ----------------------------------------------------------
# Reusable daemon workers.  A timed-out worker is poisoned: dropped from the
# pool, never joined; it exits by itself if the stuck call ever returns.


class _Job:
    __slots__ = ("fn", "args", "kwargs", "done", "result", "error")

    def __init__(self, fn, args, kwargs) -> None:
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Worker:
    __slots__ = ("_cond", "_job", "poisoned", "thread")

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._job: Optional[_Job] = None
        self.poisoned = False
        self.thread = threading.Thread(target=self._loop, name="kc-watchdog-worker",
                                       daemon=True)
        self.thread.start()

    def submit(self, job: _Job) -> None:
        with self._cond:
            self._job = job
            self._cond.notify()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._job is None:
                    self._cond.wait()
                job, self._job = self._job, None
            try:
                job.result = job.fn(*job.args, **job.kwargs)
            except BaseException as e:  # noqa: BLE001 - routed to the caller
                job.error = e
            job.done.set()
            with _pool_lock:
                if self.poisoned:
                    return
                _idle.append(self)


_pool_lock = threading.Lock()
_idle: List[_Worker] = []


def _checkout() -> _Worker:
    with _pool_lock:
        if _idle:
            return _idle.pop()
    return _Worker()


def run(site: str, fn: Callable, *args, key=None, deadline_s: Optional[float] = None,
        **kwargs):
    """``fn(*args, **kwargs)`` on a pooled worker under the (site, key)
    deadline (``deadline_s`` overrides it); ``SolveTimeout`` on overrun.
    A failed call is not a latency observation.  Inline when disabled."""
    if not watchdog_enabled():
        return fn(*args, **kwargs)
    deadline = deadline_s or deadline_for(site, key)
    job = _Job(fn, args, kwargs)
    worker = _checkout()
    t0 = time.perf_counter()
    worker.submit(job)
    if not job.done.wait(deadline):
        with _pool_lock:
            worker.poisoned = True
        # the stuck frame keeps what the call holds; the job drops the rest
        job.fn, job.args, job.kwargs = None, (), {}
        record_timeout(site)
        raise SolveTimeout(site, deadline, key)
    elapsed = time.perf_counter() - t0
    if job.error is not None:
        raise job.error
    observe(site, key, elapsed, deadline)
    return job.result


__all__ = [
    "SolveTimeout",
    "ceiling_s",
    "cold_mult",
    "deadline_for",
    "floor_s",
    "margin",
    "observe",
    "record_timeout",
    "reset_stats",
    "run",
    "stats",
    "watchdog_enabled",
]
