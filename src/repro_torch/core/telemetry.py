"""Unified telemetry: one typed, mergeable snapshot of every metrics
surface in the stack.

:class:`MetricsSnapshot` is the one shape a component reports its health
in.  Snapshots from different components merge
(:meth:`MetricsSnapshot.merge`) by the obvious per-field rule — counters
sum, peaks max, gauges from the later/other snapshot win, dict-valued
fields union.

Counterpart of ``repro/core/telemetry.py``.  In the port only
``RollMuxRuntime.metrics()`` produces snapshots so far; the engine's
``metrics()`` comes with its trace replay (ROADMAP).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, fields


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
