"""Unified telemetry: one typed, mergeable snapshot of every metrics
surface in the stack, and the spans the program records while it runs.

:class:`MetricsSnapshot` is the one shape a component reports its health
in.  Snapshots from different components merge
(:meth:`MetricsSnapshot.merge`) by the obvious per-field rule — counters
sum, peaks max, gauges from the later/other snapshot win, dict-valued
fields union.

Counterpart of ``repro/core/telemetry.py``.  In the port only
``RollMuxRuntime.metrics()`` produces snapshots so far; the engine's
``metrics()`` comes with its trace replay (ROADMAP).

*Spans* are the port's own (the JAX package has none): named intervals of
a GRPO iteration's layers, recorded in memory while recording is on
(:func:`set_recording`) and taken with :func:`take_spans`.  Each holds its
name, job id, request id, parent span, start and end
(``time.perf_counter_ns``, the clock of ``PermitPool.timeline``) and
optional ``bytes``, ``kind`` and ``device_s``.  A thread-local stack gives
each span its parent, so threads never adopt each other's spans; a span
without a job id takes its parent's (``RollMuxRuntime.phase`` and
``permit`` open a ``phase`` span carrying one).  A span given a
``device`` records a CUDA event on that device's current stream at each
end, resolved to ``device_s`` by :func:`take_spans`, never while the
program runs.  With recording off every site gets the one shared
:data:`NO_SPAN` after one check of a module-level flag, and records
nothing.  Sites stay out of anything a CUDA graph captures: an event
recorded there would be captured into the graph.
"""
from __future__ import annotations

import itertools
import threading
import time
import warnings
from dataclasses import dataclass, field, fields
from typing import Optional

import torch


def warn_legacy_once(flag: list, message: str) -> None:
    """Emit ``message`` as a :class:`DeprecationWarning` the first time the
    module-level ``flag`` (a one-element mutable list, so tests can reset
    it) is seen unset.  ``stacklevel=3`` points at the caller of the
    deprecated property, not the shim machinery."""
    if not flag[0]:
        flag[0] = True
        warnings.warn(message, DeprecationWarning, stacklevel=3)


@dataclass
class MetricsSnapshot:
    """One merged view of serving/runtime health at a point in time.

    Field classes (and their merge rule):

    * **counters** (sum): monotone totals — steps, prefills, transfers,
      sheds, … .
    * **peaks** (max): high-water marks — ``peak_active``,
      ``peak_kv_blocks``.
    * **gauges** (other wins when set): instantaneous occupancy —
      ``queue_depth``, ``num_active``, ``kv_blocks_in_use``, … .  Merging
      a router's decode + prefill snapshots sums these *before* they meet
      this rule (the router does that itself), so cross-component merges
      just keep the freshest reading.
    * **dicts** (union, other wins per key): per-pool busy fractions and
      capacities, per-class attainment.
    """

    source: str = ""

    # -- queueing / slot occupancy (gauges except the peaks/counters noted)
    queue_depth: int = 0                 # gauge: waiting requests
    rejected_submits: int = 0            # counter
    num_slots: int = 0                   # gauge: configured decode slots
    num_active: int = 0                  # gauge: live decode slots
    peak_active: int = 0                 # peak
    slot_steps: int = 0                  # counter: slot-steps with work

    # -- decode progress (counters)
    steps: int = 0
    decode_time_s: float = 0.0
    prefills: int = 0
    recorded_tokens: int = 0
    generated_tokens: int = 0

    # -- KV block pool
    kv_blocks_total: int = 0             # gauge: pool size
    kv_blocks_in_use: int = 0            # gauge
    peak_kv_blocks: int = 0              # peak

    # -- prefix sharing (counters; pinned_blocks is a gauge)
    prefix_hits: int = 0
    prefix_partial_hits: int = 0
    prefix_misses: int = 0
    prefix_evictions: int = 0
    prefix_snapshots: int = 0            # gauge: live boundary snapshots
    snapshot_demotions: int = 0          # counter: TTL demotions
    blocks_saved: int = 0
    pinned_blocks: int = 0               # gauge: radix-held blocks

    # -- suspend/resume + disaggregation
    adoptions: int = 0                   # counter
    suspends: int = 0                    # counter
    resumes: int = 0                     # counter
    suspended: int = 0                   # gauge: live suspended handles
    transfers: int = 0                   # counter
    transfer_time_s: float = 0.0         # counter
    transferred_blocks: int = 0          # counter
    transfer_backlog: int = 0            # gauge: handles awaiting adoption
    kv_routed: int = 0                   # counter

    # -- admission control (counters; attainment is a dict gauge)
    sheds: int = 0
    degrades: int = 0
    attainment: dict = field(default_factory=dict)   # class -> met fraction

    # -- runtime permit pools (dict gauges)
    pool_busy_frac: dict = field(default_factory=dict)
    pool_capacity: dict = field(default_factory=dict)

    weight_version: int = 0              # gauge

    _PEAKS = ("peak_active", "peak_kv_blocks")
    _GAUGES = ("queue_depth", "num_slots", "num_active", "kv_blocks_total",
               "kv_blocks_in_use", "prefix_snapshots", "pinned_blocks",
               "suspended", "transfer_backlog", "weight_version")
    _DICTS = ("attainment", "pool_busy_frac", "pool_capacity")

    # -- derived ------------------------------------------------------
    @property
    def time_per_token(self) -> float:
        """Mean decode step wall time (the SLO policy's EMA seed)."""
        return self.decode_time_s / max(self.steps, 1)

    @property
    def slot_utilization(self) -> float:
        """Useful tokens per slot-step of capacity offered (matches
        ``EngineStats.slot_utilization``)."""
        return self.generated_tokens / max(self.slot_steps, 1)

    @property
    def kv_block_utilization(self) -> float:
        return self.kv_blocks_in_use / max(self.kv_blocks_total, 1)

    @property
    def transfer_overhead_frac(self) -> float:
        """KV-transfer wall time as a fraction of transfer + decode time
        (zero when nothing was served)."""
        busy = self.transfer_time_s + self.decode_time_s
        if busy <= 0.0:
            return 0.0
        return self.transfer_time_s / busy

    @property
    def queue_pressure(self) -> float:
        """Waiting requests per configured slot — the controller's primary
        grow signal."""
        return self.queue_depth / max(self.num_slots, 1)

    @property
    def occupancy(self) -> float:
        """Live slots / configured slots — the controller's shrink signal."""
        return self.num_active / max(self.num_slots, 1)

    # -- merging ------------------------------------------------------
    def merge(self, other: "MetricsSnapshot") -> "MetricsSnapshot":
        """Per-field merge: counters sum, peaks max, gauges take ``other``
        when it carries a reading, dicts union with ``other`` winning per
        key.  Returns a new snapshot; neither input is mutated."""
        out = MetricsSnapshot(source=self.source or other.source)
        if self.source and other.source and other.source != self.source:
            out.source = f"{self.source}+{other.source}"
        for f in fields(self):
            if f.name == "source":
                continue
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name in self._DICTS:
                setattr(out, f.name, {**a, **b})
            elif f.name in self._PEAKS:
                setattr(out, f.name, max(a, b))
            elif f.name in self._GAUGES:
                setattr(out, f.name, b if b else a)
            else:
                setattr(out, f.name, a + b)
        return out

    @classmethod
    def merged(cls, snapshots) -> "MetricsSnapshot":
        out = cls()
        for s in snapshots:
            out = out.merge(s)
        return out

    def to_dict(self) -> dict:
        """Flat dict (dataclass fields + the derived ratios) for JSON
        reports."""
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update(time_per_token=self.time_per_token,
                 slot_utilization=self.slot_utilization,
                 kv_block_utilization=self.kv_block_utilization)
        return d


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------
_recording = False
_finished: list = []              # spans stopped and not yet taken
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


@dataclass(frozen=True)
class SpanRecord:
    """One finished span.  ``id`` is unique in the process, ``parent`` the
    id of the span open beneath it on the same thread (None at the top)
    and ``thread`` that thread's ident; ``t0_ns``, ``t1_ns`` are
    ``time.perf_counter_ns`` readings."""
    name: str
    job: Optional[str]
    rid: Optional[int]
    id: int
    parent: Optional[int]
    thread: int
    t0_ns: int
    t1_ns: int
    bytes: Optional[int] = None
    kind: Optional[str] = None
    device_s: Optional[float] = None

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _event(device):
    """A timing event recorded on the current stream of ``device`` (a
    ``torch.device`` or a tensor on it), or None off the card."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """A span being recorded: ``with span(...)``, or :meth:`start` and
    :meth:`stop` given the clock readings a caller made itself."""
    __slots__ = ("name", "job", "rid", "kind", "nbytes", "device", "id",
                 "parent", "thread", "t0", "t1", "ev0", "ev1", "dropped")

    def __init__(self, name, job, rid, kind, device):
        self.name, self.job, self.rid, self.kind = name, job, rid, kind
        self.device = device
        self.nbytes = self.ev0 = self.ev1 = None
        self.dropped = False

    def start(self, t0_ns: Optional[int] = None) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.job is None and parent is not None:
            self.job = parent.job
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self.t0 = time.perf_counter_ns() if t0_ns is None else t0_ns
        if self.device is not None:
            self.ev0 = _event(self.device)
        stack.append(self)
        return self

    def stop(self, t1_ns: Optional[int] = None) -> None:
        """End the span (and any span still open above it on this thread,
        which an exception left behind: those are not recorded)."""
        self.t1 = time.perf_counter_ns() if t1_ns is None else t1_ns
        if self.device is not None and self.ev0 is not None:
            self.ev1 = _event(self.device)
        stack = _stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i:]
                break
        if not self.dropped:
            with _lock:
                _finished.append(self)

    def note(self, nbytes: Optional[int] = None, start=None, end=None):
        """Attach the bytes the span moved and the CUDA events around its
        device work, where the caller recorded them itself."""
        if nbytes is not None:
            self.nbytes = nbytes
        if start is not None:
            self.ev0, self.ev1 = start, end

    def discard(self) -> None:
        """Record nothing when the span stops."""
        self.dropped = True

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


class _NoSpan:
    """What every site gets with recording off: does nothing."""
    __slots__ = ()

    def start(self, t0_ns=None):
        return self

    def stop(self, t1_ns=None):
        pass

    def note(self, nbytes=None, start=None, end=None):
        pass

    def discard(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, *, job: Optional[str] = None, rid: Optional[int] = None,
         kind: Optional[str] = None, device=None):
    """A span named ``name`` (:data:`NO_SPAN` with recording off).
    ``device`` (a ``torch.device`` or a tensor on it) asks for the span's
    device seconds: a CUDA event at each end, on the current stream."""
    if not _recording:
        return NO_SPAN
    return Span(name, job, rid, kind, device)


def phase_span(who: str):
    """The ``phase`` span of a run permit labelled ``job:phase``, as the
    pool timelines label it."""
    if not _recording:
        return NO_SPAN
    job, _, kind = who.partition(":")
    return Span("phase", job, None, kind or None, None)


def set_recording(on: bool) -> None:
    """Turn span recording on or off (off at import)."""
    global _recording
    _recording = bool(on)


def take_spans() -> list[SpanRecord]:
    """Every span finished since the last take, in the order they ended,
    their device seconds resolved (waiting for their end events); the
    recorder keeps none of them."""
    global _finished
    with _lock:
        spans, _finished = _finished, []
    out = []
    for s in spans:
        device_s = None
        if s.ev0 is not None and s.ev1 is not None:
            s.ev1.synchronize()
            device_s = s.ev0.elapsed_time(s.ev1) / 1e3
        out.append(SpanRecord(s.name, s.job, s.rid, s.id, s.parent,
                              s.thread, s.t0, s.t1, s.nbytes, s.kind,
                              device_s))
    return out
