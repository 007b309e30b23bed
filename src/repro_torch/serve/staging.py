"""Asynchronous double-buffered host↔device staging (paper §V co-processing),
in PyTorch.  Mirrors ``repro.serve.staging``.

The host-resident backend (:class:`~repro_torch.core.backend.OffloadBackend`)
moves three kinds of payload per layer: a compact host **gather** of the rows
the plan touches, the **H2D** staging copy, and the **D2H write-back** of the
updated rows.  The :class:`HostStagingPipeline` moves the host-memory halves
onto one background worker so they overlap the device's compute:

                 batch t                               batch t+1
  caller   put/exec L0 ─ d2h L0 ─ put/exec L1 ─ d2h L1 ─ ... plan(t+1) ...
  worker  [G0][G1][G2]···[WB0 scatter]······[WB1 scatter][WBfinal][G0']···
  device  ───[compute L0]───────[compute L1]───────[compute L2]──[L0']──

  G l   = pristine host gather of layer l's staging buffers (submitted for
          every layer at dispatch start, value-independent — see below)
  WB l  = host scatter of layer l's D2H'd outputs into the resident state
  d2h l = the caller's only block: device completion of layer l's copy-out

Why pristine gathers can all be submitted up front: within a batch, layer
*l*'s staging reads ``h[l]`` (written only by write-back *l-1*), ``a[l]``/
``nct[l]``/``h[l+1]`` (written only by write-back *l*).  Gathering the
**pre-batch** state therefore yields exactly the *old* view; the *new* view
is the same rows patched with the previous layer's freshly computed outputs.
The single in-order worker queue makes "pristine" precise: all of batch t's
gathers are enqueued before any of batch t's write-backs, and batch t+1's
gathers are enqueued after batch t's final write-back.

Mechanics:

* **two staging buffer sets per layer** — grow-only host buffers, alternated
  per batch (``begin_batch``) so a set being consumed by batch t's H2D is
  never the set batch t+1's gathers fill.  On a card they are **pinned**
  (``torch.empty(..., pin_memory=True)``, filled through a ``.numpy()``
  view), so ``np.take(..., out=)`` writes straight into page-locked memory
  and the H2D and D2H copies are ``non_blocking``.  A set is reused two
  batches later; its last copy records a CUDA event
  (:meth:`StagingBuffers.mark_in_flight`) and the gather that refills it
  waits on that event first (:meth:`StagingBuffers.wait_free`), so no
  gather overwrites rows an in-flight copy still reads;
* **CUDA stays on the caller thread** — the caller takes (allocates) the
  pinned buffers, issues every copy and records every event
  (:meth:`HostStagingPipeline.copy_out`); the worker only waits on events
  and runs numpy;
* **depth-2 request queue** (:data:`QUEUE_DEPTH`) — at most two staging
  jobs in flight gives the one-ahead prefetch the schedule needs while
  bounding host memory and providing back-pressure;
* **explicit phases** — ``submit_gather`` / ``wait_gather`` (caller blocks
  for staged buffers), ``copy_out`` + ``wait_device`` (caller blocks for
  D2H; this is the device-compute window), ``submit_writeback``, and
  ``drain`` (full barrier: queue empty, worker idle, worker exceptions
  re-raised on the caller thread — the backend's ``flush()`` calls it);
* **sync escape hatch** — ``async_mode=False`` executes every submitted job
  inline on the caller thread.  Both modes run byte-identical numpy work,
  so the async path is bitwise-identical to the sync path.

Deterministic counters (``StagingStats.staged_bytes``, job counts) are
functions of the plans; the timing counters (``wait_gather_s``/
``wait_device_s``/``work_*``) are telemetry for ``StreamStats.sync_wait_s``
vs ``compute_s``.  With the device hot-row cache
(:mod:`repro_torch.serve.hotcache`) the backend submits miss-only gather
jobs: the staged payload (and ``staged_bytes``) shrinks by the cached
fraction.  The serving front-end only gathers at version boundaries, after
the backend's ``flush()`` has drained the queue (``idle`` is then True).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


#: in-flight job bound of the worker queue: the double-buffered one-ahead
#: prefetch needs two
QUEUE_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class StagingConfig:
    """Typed knobs for the host staging pipeline (nested in
    :class:`repro_torch.serve.api.EngineConfig` as ``staging=``).

    ``async_enabled`` selects the background worker (False = the inline
    bitwise-identical escape hatch)."""

    async_enabled: bool = True


@dataclasses.dataclass
class StagingStats:
    """Pipeline counters.  ``staged_bytes``/job counts are deterministic
    functions of the plan; the ``*_s`` fields are wall-clock telemetry."""

    staged_bytes: int = 0  # gather payload + write-back payload, in bytes
    gather_jobs: int = 0
    writeback_jobs: int = 0
    wait_gather_s: float = 0.0  # caller blocked waiting for staged buffers
    wait_device_s: float = 0.0  # caller blocked in D2H (device compute window)
    drain_wait_s: float = 0.0  # caller blocked in drain() barriers
    work_gather_s: float = 0.0  # worker (or inline) time executing gathers
    work_writeback_s: float = 0.0

    def snapshot(self) -> "StagingStats":
        return dataclasses.replace(self)


class StagingTicket:
    """Completion handle for one submitted staging job."""

    __slots__ = ("_event", "result", "error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self) -> Any:
        self._event.wait()
        if self.error is not None:
            raise RuntimeError("host staging job failed") from self.error
        return self.result


class DeviceCopy:
    """Device → host copies in flight: ``arrays`` are the host buffers they
    land in, ``event`` (None on the CPU) passes when they have landed."""

    __slots__ = ("arrays", "event")

    def __init__(self, arrays: Tuple[np.ndarray, ...], event) -> None:
        self.arrays = arrays
        self.event = event

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays)

    def wait(self) -> Tuple[np.ndarray, ...]:
        if self.event is not None:
            self.event.synchronize()
        return self.arrays


def _host_empty(shape: Tuple[int, ...], dtype, pinned: bool) -> np.ndarray:
    """An uninitialised host array, in page-locked memory when ``pinned``."""
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(shape, dtype=tdt, pin_memory=pinned).numpy()


class StagingBuffers:
    """One grow-only named staging buffer set (half of a layer's pair).

    Buffers are keyed by ``(name, trailing shape, dtype)`` and grow only
    along axis 0, so ``take`` always returns a C-contiguous view that
    ``np.take(..., out=)`` can fill without an intermediate allocation.
    ``pinned`` backs them with page-locked memory (the card's case)."""

    def __init__(self, pinned: bool = False) -> None:
        self.pinned = pinned
        self._bufs: Dict[Tuple, np.ndarray] = {}
        self._in_flight = None  # CUDA event after the set's last copy
        self._retired: list = []  # outgrown buffers a queued copy may still use

    def take(self, name: str, rows: int, trailing: Tuple[int, ...],
             dtype=np.float32) -> np.ndarray:
        """A ``[rows, *trailing]`` view of the named buffer, grown (≥ 2×) if
        too small.  Allocates page-locked memory when ``pinned``, so the
        caller thread takes the buffers; an outgrown buffer stays alive
        until :meth:`wait_free`, since a queued copy may still use it."""
        key = (name, trailing, np.dtype(dtype).str)
        buf = self._bufs.get(key)
        if buf is None or buf.shape[0] < rows:
            if buf is not None:
                self._retired.append(buf)
            cap = max(rows, 2 * buf.shape[0] if buf is not None else rows)
            buf = _host_empty((cap,) + tuple(trailing), dtype, self.pinned)
            self._bufs[key] = buf
        return buf[:rows]

    def mark_in_flight(self, event) -> None:
        """Record that a copy reading or writing this set is queued on the
        device; ``event`` passes once it is done (None: nothing in flight)."""
        self._in_flight = event

    def wait_free(self) -> None:
        """Block until no queued copy still uses this set (before a refill)."""
        event, self._in_flight = self._in_flight, None
        if event is not None:
            event.synchronize()
        self._retired.clear()

    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._bufs.values())


class HostStagingPipeline:
    """Background host-staging worker: a :data:`QUEUE_DEPTH`-deep in-order
    job queue, two :class:`StagingBuffers` sets per layer, exception capture
    with re-raise at ``drain()``.  See the module docstring for the
    schedule."""

    def __init__(self, num_layers: int, async_mode: bool = True, name: str = "staging",
                 pinned: bool = False) -> None:
        self.num_layers = num_layers
        self.async_mode = async_mode
        self.pinned = pinned
        self.stats = StagingStats()
        # test seams: called inside the worker before each job body runs
        # (fault injection / artificial gather slowdown)
        self.gather_hook: Optional[Callable[[Any], None]] = None
        self.writeback_hook: Optional[Callable[[Any], None]] = None
        self._buffers = [(StagingBuffers(pinned), StagingBuffers(pinned))
                         for _ in range(num_layers)]
        self._parity = 0
        self._failure: Optional[BaseException] = None
        self._q: Optional[queue.Queue] = None
        if async_mode:
            self._q = queue.Queue(maxsize=QUEUE_DEPTH)
            # the worker holds only a weakref to the pipeline (plus the
            # queue), so a dropped engine does not leak its pipeline,
            # staging buffers, or worker thread
            self._worker = threading.Thread(
                target=_worker_loop, args=(weakref.ref(self), self._q),
                name=f"{name}-worker", daemon=True)
            self._worker.start()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter shutdown: the daemon worker dies anyway

    # ------------------------------------------------------------------ #
    # buffer management
    # ------------------------------------------------------------------ #
    def begin_batch(self) -> None:
        """Flip the double buffers: this batch's gathers fill the set the
        previous batch was *not* staging from."""
        self._parity ^= 1

    def buffers(self, layer: int) -> StagingBuffers:
        """The staging buffer set for ``layer`` in the current parity."""
        return self._buffers[layer][self._parity]

    def buffer_bytes(self) -> int:
        return sum(s.nbytes() for pair in self._buffers for s in pair)

    # ------------------------------------------------------------------ #
    # phases
    # ------------------------------------------------------------------ #
    def submit_gather(self, fn: Callable[[], Any], tag: Any = None) -> StagingTicket:
        """Enqueue a host gather producing staged buffers (a dict/tuple of
        arrays); value-independent of any in-flight write-back by the
        in-order-queue contract."""
        self.stats.gather_jobs += 1
        return self._submit(fn, "gather", tag)

    def wait_gather(self, ticket: StagingTicket) -> Any:
        """Block until a gather's staged buffers are ready (re-raising a
        worker failure here, on the caller thread)."""
        t0 = time.perf_counter()
        out = ticket.wait()
        self.stats.wait_gather_s += time.perf_counter() - t0
        if out is not None:
            self.stats.staged_bytes += sum(int(a.nbytes) for a in _iter_arrays(out))
        return out

    def copy_out(self, outs: Sequence[torch.Tensor], bufs: StagingBuffers) -> DeviceCopy:
        """Issue the D2H of ``outs`` into ``bufs`` (``non_blocking`` into
        pinned memory on a card) and record an event after it.  Caller
        thread only: it returns at once; :meth:`wait_device` (caller) or
        :meth:`DeviceCopy.wait` (a write-back job) blocks for the data."""
        host = []
        for i, o in enumerate(outs):
            dst = bufs.take(f"out{i}", o.shape[0], tuple(o.shape[1:]))
            torch.from_numpy(dst).copy_(o, non_blocking=o.device.type == "cuda")
            host.append(dst)
        event = None
        if any(o.device.type == "cuda" for o in outs):
            event = torch.cuda.Event()
            event.record()
        return DeviceCopy(tuple(host), event)

    def wait_device(self, copy: DeviceCopy) -> Tuple[np.ndarray, ...]:
        """Block until a :meth:`copy_out` has landed.  This wait *is* the
        device-compute window the worker's gathers and write-backs hide
        behind."""
        t0 = time.perf_counter()
        host = copy.wait()
        self.stats.wait_device_s += time.perf_counter() - t0
        return host

    def submit_writeback(self, fn: Callable[[], Any], nbytes: int = 0,
                         tag: Any = None) -> StagingTicket:
        """Enqueue a host scatter of written-back rows (host arrays, or a
        :class:`DeviceCopy` the job waits on first for the deferred final
        layer)."""
        self.stats.writeback_jobs += 1
        self.stats.staged_bytes += int(nbytes)
        return self._submit(fn, "writeback", tag)

    @property
    def idle(self) -> bool:
        """True when no submitted job is queued or running (always True in
        sync mode) — the state a version-boundary snapshot read relies on."""
        return self._q is None or self._q.unfinished_tasks == 0

    def drain(self) -> None:
        """Full barrier: every submitted job has executed and any worker
        exception is re-raised here, on the caller thread."""
        if self._q is not None:
            t0 = time.perf_counter()
            self._q.join()
            self.stats.drain_wait_s += time.perf_counter() - t0
        if self._failure is not None:
            err, self._failure = self._failure, None
            raise RuntimeError("host staging worker failed") from err

    def close(self) -> None:
        """Stop the worker.  Called by ``__del__`` when the owning backend
        is dropped; safe to call explicitly and idempotent."""
        if self._q is not None:
            q, self._q = self._q, None
            q.put(None)

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def _submit(self, fn, kind: str, tag) -> StagingTicket:
        ticket = StagingTicket()
        if self._q is None:  # sync escape hatch: identical work, inline
            t0 = time.perf_counter()
            try:
                self._exec(ticket, fn, kind, tag)
            finally:
                self._account_work(kind, time.perf_counter() - t0)
            if ticket.error is not None:
                self._failure = None  # propagated right here instead
                raise RuntimeError("host staging job failed") from ticket.error
            return ticket
        self._q.put((ticket, fn, kind, tag))
        return ticket

    def _exec(self, ticket: StagingTicket, fn, kind: str, tag) -> None:
        try:
            hook = self.gather_hook if kind == "gather" else self.writeback_hook
            if hook is not None:
                hook(tag)
            ticket.result = fn()
        except BaseException as e:  # surfaced by wait()/drain(), never lost
            ticket.error = e
            if self._failure is None:
                self._failure = e
        finally:
            ticket._event.set()

    def _account_work(self, kind: str, dt: float) -> None:
        if kind == "gather":
            self.stats.work_gather_s += dt
        else:
            self.stats.work_writeback_s += dt


def _worker_loop(pipe_ref: "weakref.ref[HostStagingPipeline]", q: queue.Queue) -> None:
    """Module-level worker body: holds the queue strongly but the pipeline
    only weakly, so the thread never pins a dropped engine's buffers."""
    while True:
        job = q.get()
        if job is None:
            q.task_done()
            return
        ticket, fn, kind, tag = job
        pipe = pipe_ref()
        if pipe is None:  # owner collected mid-queue: nobody can wait on us
            ticket._event.set()
            q.task_done()
            return
        t0 = time.perf_counter()
        try:
            pipe._exec(ticket, fn, kind, tag)
        finally:
            pipe._account_work(kind, time.perf_counter() - t0)
            q.task_done()
            del pipe  # drop the strong ref before blocking on q.get()


def _iter_arrays(obj):
    """Yield the staged ndarrays of a gather payload for byte accounting.

    Dict entries whose key starts with ``"_"`` are not payload (the layer's
    whole pinned byte buffer, its index tables): counting them would charge
    ``staged_bytes`` for bytes the reference does not count, so they are
    skipped."""
    if isinstance(obj, np.ndarray):
        yield obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(k, str) and k.startswith("_"):
                continue
            yield from _iter_arrays(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _iter_arrays(v)
