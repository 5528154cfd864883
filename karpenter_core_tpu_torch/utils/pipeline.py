"""The pipelined tick's primitives on CUDA streams: fetch tickets, the host
staging ring, the tick ring, and the donation ledger.

A copy of ``karpenter_core_tpu/utils/pipeline.py`` in meaning.  The serial
tick dispatches solve k, blocks on its device-to-host fetch, materializes
the results, and only then dispatches solve k+1.  These pieces let the
fetch of one tick overlap the next tick's host work:

  FetchTicket       splits "dispatch" from "fetch".  Construction records a
                    CUDA event on the compute stream; a dedicated copy
                    stream waits on it and copies every array into pinned
                    host buffers (``non_blocking``).  Each source tensor is
                    marked used by the copy stream (``record_stream``), so
                    the caching allocator cannot hand its memory to the next
                    tick while the copy still reads it.  ``wait()`` is the
                    barrier: it polls the copy's completion event against
                    the watchdog deadline (``utils/watchdog.py``), and only
                    then exposes the host arrays as numpy.  ``hidden_s``
                    (dispatch to barrier) and ``exposed_s`` (what the barrier
                    blocked) land on the ticket and in ``last_overlap()``.
  HostStagingRing   ``depth`` slots of reusable host buffers the tickets
                    land in, so steady ticks allocate none.  A slot is
                    rewritten only after the copy last landed there has
                    completed (its event is kept and waited on).  A buffer
                    is bytes that an array of any shape and type views, so
                    a smaller array reuses them and only growth allocates.
                    ``staging_reallocs`` counts as the reference's does:
                    every change of an array's shape or dtype in a slot
                    filled before (a first fill is not drift), whether or
                    not the bytes had to grow.
  SolvePipeline     the depth-N tick ring: ``submit(dispatch)`` dispatches
                    now and returns the oldest in-flight tick's results once
                    the ring is full; ``drain()`` retires the rest.

On a CPU device (the tests) the ring holds plain host tensors and a ticket
copies at construction: CPU-only torch cannot pin memory.

Carry donation rides the same switch: ``donation_enabled()`` lets a warm
repair free evictions into the carry in place (K21) and scatter its window
into the full-width carry in place (K22) instead of writing fresh
full-width planes every tick.  ``record_donation`` keeps the ledger.
``KC_PIPELINE=0`` turns all of it off (the serial loop, K10 and K12);
``KC_PIPELINE_DEPTH`` (default 2) sizes the ring.

Left out, for a later slice (ROADMAP 1.5): the ``pipeline.overlap`` span
and the ring-occupancy and overlap-ratio gauges; ``fetch_tree`` and
``start_host_copy`` (their callers, the sweep's and the tenant coalescer's
fetches, read the host directly in the port).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch

from karpenter_core_tpu_torch.utils import watchdog

FETCH_SITE = "pipeline.fetch"
_POLL_S = 20e-6  # the barrier's sleep between event queries

_lock = threading.Lock()
_stats = {
    # warm dispatches that consumed the carry in place
    "donated": 0,
    # warm dispatches that kept the carry: donation off (KC_PIPELINE=0, an
    # enabled policy, a hooked dispatch)
    "donation_reallocs": 0,
    # staging-ring buffers regrown because an array needed more bytes than
    # its slot held (a slot's first fill is the working set, not drift)
    "staging_reallocs": 0,
    # donated dispatches whose tick was invalidated after a failed barrier:
    # donated == donation_canceled + live donated dispatches at all times
    "donation_canceled": 0,
    # FetchTickets constructed minus tickets retired (first successful wait,
    # or invalidate); a leak-free loop returns it to 0
    "tickets_open": 0,
}
_last_overlap: Dict[str, float] = {"hidden_s": 0.0, "exposed_s": 0.0}
_copy_streams: Dict[int, "torch.cuda.Stream"] = {}


def pipeline_enabled() -> bool:
    """KC_PIPELINE=0 restores the serial loop: no deferred ticks, no
    donation, no staging."""
    return os.environ.get("KC_PIPELINE", "1") != "0"


def pipeline_depth() -> int:
    """Ring depth (staging slots, in-flight ticks + 1); at least 2, the
    double buffer."""
    try:
        return max(int(os.environ.get("KC_PIPELINE_DEPTH", "2")), 2)
    except ValueError:
        return 2


def backend_supports_donation() -> bool:
    """True on every torch device.  The reference probes whether XLA honours
    ``donate_argnums`` (older XLA:CPU ignores it and keeps the input alive);
    here donation is an in-place kernel or its in-place twin, which always
    consumes the carry it is given, on the card and on the CPU alike."""
    return True


def donation_enabled() -> bool:
    """Whether warm repairs free and scatter into their carry in place."""
    return pipeline_enabled() and backend_supports_donation()


def record_donation(engaged: bool) -> None:
    with _lock:
        _stats["donated" if engaged else "donation_reallocs"] += 1


def record_donation_canceled() -> None:
    """A donated dispatch's tick was invalidated: its carry is dead without
    its results ever being applied."""
    with _lock:
        _stats["donation_canceled"] += 1


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        for k in _stats:
            _stats[k] = 0


def last_overlap() -> Dict[str, float]:
    """The most recent ``FetchTicket.wait()`` overlap record."""
    with _lock:
        return dict(_last_overlap)


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The card's dedicated device-to-host copy stream."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _lock:
        stream = _copy_streams.get(index)
        if stream is None:
            stream = torch.cuda.Stream(device=index)
            _copy_streams[index] = stream
        return stream


def _pinned(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=_pinned(t))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Slot:
    __slots__ = ("store", "bufs", "shapes", "event")

    def __init__(self) -> None:
        self.store: List[Optional[torch.Tensor]] = []  # u8 byte buffers
        self.bufs: List[Optional[torch.Tensor]] = []  # the views handed out
        self.shapes: List[Optional[Tuple]] = []  # (shape, dtype) last staged at each index
        self.event = None  # the completion event of the copy last landed here


class HostStagingRing:
    """A ring of reusable host buffer sets (module docstring).  Slot k is
    handed out again ``depth`` takes later, after its last copy completed."""

    def __init__(self, depth: Optional[int] = None) -> None:
        self.depth = depth or pipeline_depth()
        self._slots = [_Slot() for _ in range(self.depth)]
        self._next = 0

    def take(self, arrays: Tuple) -> _Slot:
        """The next slot, with host buffers shaped like ``arrays`` (tensors
        or None) in ``slot.bufs``: views of the slot's byte buffers, grown
        where an array needs more bytes than they hold.  A change of shape
        or dtype at an index the slot held before counts in
        ``staging_reallocs``, as the reference's rebuild does; a first fill
        and a None entry do not (a None leaves the index as it was)."""
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.depth
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        while len(slot.store) < len(arrays):
            slot.store.append(None)
            slot.shapes.append(None)
        bufs = []
        drift = 0
        for i, a in enumerate(arrays):
            if a is None:
                bufs.append(None)
                continue
            layout = (tuple(a.shape), a.dtype)
            if slot.shapes[i] is not None and slot.shapes[i] != layout:
                drift += 1
            slot.shapes[i] = layout
            store = slot.store[i]
            need = _nbytes(a)
            if store is None or store.numel() < need or store.is_pinned() != _pinned(a):
                store = torch.empty(need, dtype=torch.uint8, pin_memory=_pinned(a))
                slot.store[i] = store
            bufs.append(store[:need].view(a.dtype).view(layout[0]))
        if drift:
            with _lock:
                _stats["staging_reallocs"] += drift
        slot.bufs = bufs
        return slot

    @staticmethod
    def drop(slot: _Slot) -> None:
        """Forget a slot's buffers (a ticket abandoned with its copy maybe
        still in flight): the next take of the slot fills fresh ones.  The
        shapes it last held stay, so drift is still counted against them."""
        slot.store, slot.bufs = [None] * len(slot.store), []
        slot.event = None


class FetchTicket:
    """One solve's device-to-host fetch, split from its dispatch (module
    docstring).  ``follow(tensors)`` queues further copies behind the
    ticket's own, into fresh host buffers the barrier also covers."""

    __slots__ = ("_srcs", "_bufs", "_extra", "_slot", "_done", "_host", "_label",
                 "_t_dispatch", "_open", "_invalid", "hidden_s", "exposed_s", "planes")

    def __init__(self, arrays: Tuple, ring: Optional[HostStagingRing] = None,
                 label: str = "solve") -> None:
        self._label = label
        self._host: Optional[Tuple] = None
        self._open = True
        self._invalid = False
        self._done = None
        self._extra: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.hidden_s = 0.0
        self.exposed_s = 0.0
        # decode's big planes ride the ticket (solver.cuda.begin_fetch)
        self.planes = None
        self._t_dispatch = time.perf_counter()
        with _lock:
            _stats["tickets_open"] += 1
        if ring is not None:
            self._slot = ring.take(arrays)
            self._bufs = self._slot.bufs
        else:
            self._slot = None
            self._bufs = [None if a is None else _host_like(a) for a in arrays]
        self._srcs = tuple(arrays)
        self._copy(list(zip(self._srcs, self._bufs)))

    def _copy(self, pairs) -> None:
        pairs = [(src, buf) for src, buf in pairs if src is not None]
        if not pairs:
            return
        dev = pairs[0][0].device
        if dev.type != "cuda":
            for src, buf in pairs:
                buf.copy_(src)
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        stream = copy_stream(dev)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            for src, buf in pairs:
                src.record_stream(stream)
                buf.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        self._done = done
        if self._slot is not None:
            self._slot.event = done

    def follow(self, tensors) -> List[torch.Tensor]:
        """Copy ``tensors`` behind the ticket's arrays into fresh host
        buffers, returned now and readable after ``wait()``."""
        bufs = [_host_like(t) for t in tensors]
        self._copy(list(zip(tensors, bufs)))
        self._extra.extend(zip(tensors, bufs))
        return bufs

    def done(self) -> bool:
        return self._host is not None

    @property
    def staged(self) -> bool:
        return self._slot is not None

    def _ready(self) -> bool:
        """Whether every copy of the ticket has landed (the barrier's poll)."""
        return self._done is None or self._done.query()

    def _close(self) -> None:
        if self._open:
            self._open = False
            with _lock:
                _stats["tickets_open"] -= 1

    def invalidate(self) -> None:
        """Cancel the ticket after a failed or abandoned barrier: drop its
        device and host references (its staging slot is forgotten, since the
        copy may still land there) and retire it from the open ledger; a
        later ``wait()`` raises."""
        if self._slot is not None and self._slot.bufs is self._bufs:
            HostStagingRing.drop(self._slot)
        self._srcs, self._bufs, self._extra = (), [], []
        self.planes = None
        self._invalid = True
        self._close()

    def wait(self) -> Tuple:
        """The barrier: the host arrays (numpy), once every copy has landed
        within the watchdog deadline; ``SolveTimeout`` otherwise."""
        if self._invalid:
            raise RuntimeError(
                f"FetchTicket({self._label}) was invalidated after a failed barrier; "
                "its tick re-anchors instead"
            )
        if self._host is None:
            t_block = time.perf_counter()
            if watchdog.watchdog_enabled():
                deadline = watchdog.deadline_for(FETCH_SITE, self._label)
            else:
                deadline = float("inf")
            while not self._ready():
                if time.perf_counter() - t_block >= deadline:
                    watchdog.record_timeout(FETCH_SITE)
                    raise watchdog.SolveTimeout(FETCH_SITE, deadline, self._label)
                time.sleep(_POLL_S)
            t_end = time.perf_counter()
            if deadline != float("inf"):
                watchdog.observe(FETCH_SITE, self._label, t_end - t_block, deadline)
            self._host = tuple(None if b is None else b.numpy() for b in self._bufs)
            # drop the device references: the carry may be written in place
            # by the next tick
            self._srcs, self._extra = (), []
            self._close()
            self.hidden_s = max(t_block - self._t_dispatch, 0.0)
            self.exposed_s = max(t_end - t_block, 0.0)
            with _lock:
                _last_overlap["hidden_s"] = self.hidden_s
                _last_overlap["exposed_s"] = self.exposed_s
        return self._host


class SolvePipeline:
    """Depth-N tick ring for a deferred tick loop.  ``submit(dispatch)``
    calls ``dispatch()`` (a handle with ``result()``, e.g.
    ``solver.incremental.PendingResults``), enqueues it, and once ``depth -
    1`` handles are in flight retires the oldest by its ``result()``.  A
    ``dispatch()`` that raises enqueues nothing; earlier handles stay
    consumable through ``drain()``."""

    def __init__(self, depth: Optional[int] = None) -> None:
        self.depth = depth or pipeline_depth()
        self._inflight: deque = deque()

    def submit(self, dispatch: Callable[[], object]):
        """The oldest in-flight tick's results, or None while the ring
        fills."""
        handle = dispatch()
        self._inflight.append(handle)
        if len(self._inflight) >= self.depth:
            return self._inflight.popleft().result()
        return None

    def drain(self) -> List[object]:
        out = []
        while self._inflight:
            out.append(self._inflight.popleft().result())
        return out

    def __len__(self) -> int:
        return len(self._inflight)


__all__ = [
    "FETCH_SITE",
    "FetchTicket",
    "HostStagingRing",
    "SolvePipeline",
    "backend_supports_donation",
    "copy_stream",
    "donation_enabled",
    "last_overlap",
    "pipeline_depth",
    "pipeline_enabled",
    "record_donation",
    "record_donation_canceled",
    "reset_stats",
    "stats",
]
