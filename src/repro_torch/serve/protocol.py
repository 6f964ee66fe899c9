"""The written engine contract: what a rollout executor may drive.

Counterpart of ``repro/serve/protocol.py``.  ``DisaggRouter`` duck-types
the ``Engine`` surface that ``run_trace``, ``generate_continuous``, the
streaming executor and the agentic driver drive; :class:`EngineProtocol`
writes that surface down once, and the conformance test holds both
implementations to it.

Beyond the methods a protocol can express, conforming engines carry the
data surface drivers read (:data:`ENGINE_ATTRS`), checked attribute by
attribute, since ``runtime_checkable`` protocols check callables only.
The port adds ``device`` (the card unless the caller asked for the CPU);
``reset`` takes a ``torch.Generator`` where the JAX package takes a key.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

#: Data attributes every conforming engine exposes.
ENGINE_ATTRS = ("config", "params", "paged", "slots", "queue", "finished",
                "stats", "radix", "num_active", "idle", "clock",
                "weight_version", "suspended", "device")


@runtime_checkable
class EngineProtocol(Protocol):
    """Continuous-batching engine surface (monolithic or disaggregated).

    ``submit`` feeds the waiting queue, ``step`` runs one scheduler tick,
    ``harvest`` drains finished outputs without stopping the engine,
    ``run`` drives to idle.  ``reset`` readies a persistent engine for
    the next GRPO iteration (``carry_live=True`` suspends and resumes live
    generations across the weight swap).  ``export_state`` /
    ``import_state`` checkpoint mid-flight.  ``suspend`` / ``resume``
    (and ``harvest_suspended`` for stop-token boundaries) are the
    multi-turn lifecycle, and ``admit_prefilled`` the KV adoption path
    they share with disaggregated transfer."""

    def submit(self, req) -> bool: ...

    def step(self) -> int: ...

    def metrics(self): ...    # -> core.telemetry.MetricsSnapshot

    def run(self, *, max_ticks: Optional[int] = None,
            should_yield=None): ...

    def harvest(self) -> list: ...

    def reset(self, params=None, generator=None, *,
              carry_live: bool = False) -> None: ...

    def export_state(self) -> dict: ...

    def import_state(self, state: dict) -> None: ...

    def can_admit_prefilled(self, req) -> bool: ...

    def admit_prefilled(self, req, logits, one) -> int: ...

    def suspend(self, rid: int): ...

    def harvest_suspended(self) -> list: ...

    def can_resume(self, sreq, tool_tokens=(), *,
                   max_new_tokens: Optional[int] = None) -> bool: ...

    def resume(self, sreq, tool_tokens=(), *,
               max_new_tokens: Optional[int] = None,
               rid: Optional[int] = None,
               stop_tokens: Optional[tuple] = None,
               continue_output: bool = False) -> int: ...
