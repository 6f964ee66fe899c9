"""``RolloutSpec``: one description of how rollouts are served.

Counterpart of ``repro/serve/spec.py``.  The engine-shape knobs
(``num_slots``, ``kv_layout``, ``kv_block_size``, ``num_kv_blocks``,
``sched``, ``prefix_share``, ``disagg``, ``kv_dtype``, ...) live here
once: a spec derives the per-session
:class:`~repro_torch.serve.engine.EngineConfig` or
:class:`~repro_torch.serve.router.DisaggConfig` (adding the session's
sampler and sequence budget) and builds the engine.
:meth:`RolloutSpec.from_args` reads the argparse namespaces of both
``launch/serve.py`` and ``launch/train.py``.  The port has no decode
backend switch, so the JAX spec's ``kernel_backend`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.router import DisaggConfig, DisaggRouter


@dataclass(frozen=True)
class RolloutSpec:
    """Engine shape and rollout-session fields, sampler- and
    batch-agnostic.

    ``disagg`` selects disaggregated prefill/decode serving: ``None``
    (monolithic), ``True`` (``num_slots`` split 1:3 prefill:decode), a
    dict of :class:`DisaggConfig` overrides, or a whole ``DisaggConfig``.
    ``group``/``job_id`` tag GRPO prompt groups and the submitting job.
    Sharing is by content; ``prefix_namespace`` is an optional radix
    isolation namespace for requests that must not share across a tenant
    boundary.  ``carry`` opts the streaming executor into partial-rollout
    continuation."""
    num_slots: Optional[int] = None      # default: one slot per request
    block_size: int = 1
    kv_layout: str = "contiguous"
    kv_block_size: int = 16
    num_kv_blocks: Optional[int] = None
    sched: str = "fifo"
    prefix_share: bool = False
    kv_dtype: Optional[str] = None
    disagg: Any = None                   # None | True | dict | DisaggConfig
    group: Optional[int] = None
    job_id: Optional[str] = None
    carry: bool = False
    prefix_namespace: Any = None         # radix isolation namespace

    def replace(self, **kw) -> "RolloutSpec":
        return dataclasses.replace(self, **kw)

    # ---- config derivation -------------------------------------------------
    def engine_config(self, *, batch: int, max_seq_len: int, eos_id: int,
                      temperature: float,
                      max_waiting: Optional[int] = None) -> EngineConfig:
        return EngineConfig(
            num_slots=batch if self.num_slots is None else self.num_slots,
            max_seq_len=max_seq_len, eos_id=eos_id, temperature=temperature,
            block_size=self.block_size, max_waiting=max_waiting,
            kv_layout=self.kv_layout, kv_block_size=self.kv_block_size,
            num_kv_blocks=self.num_kv_blocks, sched=self.sched,
            prefix_share=self.prefix_share, kv_dtype=self.kv_dtype)

    def disagg_config(self, *, batch: int, max_seq_len: int, eos_id: int,
                      temperature: float) -> Optional[DisaggConfig]:
        """The two-pool shape, or ``None`` when serving monolithic.
        ``disagg=True`` splits ``num_slots`` 1:3 prefill:decode; a dict
        overrides any ``DisaggConfig`` field."""
        if not self.disagg:
            return None
        if isinstance(self.disagg, DisaggConfig):
            return self.disagg
        n = batch if self.num_slots is None else self.num_slots
        opts = {} if self.disagg is True else dict(self.disagg)
        pf = opts.pop("prefill_slots", max(1, n // 4))
        return DisaggConfig(
            prefill_slots=pf,
            decode_slots=opts.pop("decode_slots", max(1, n - pf)),
            max_seq_len=max_seq_len, eos_id=eos_id, temperature=temperature,
            block_size=self.block_size, kv_layout=self.kv_layout,
            kv_block_size=self.kv_block_size,
            decode_kv_blocks=opts.pop("decode_kv_blocks",
                                      self.num_kv_blocks),
            sched=self.sched, prefix_share=self.prefix_share,
            kv_dtype=opts.pop("kv_dtype", self.kv_dtype), **opts)

    def build_engine(self, model, params, *, batch: int, max_seq_len: int,
                     eos_id: int, temperature: float, generator=None,
                     policy=None, device=None, runtime=None):
        """The engine this spec describes: a monolithic
        :class:`~repro_torch.serve.engine.Engine` or a
        :class:`~repro_torch.serve.router.DisaggRouter` (both satisfy
        :class:`~repro_torch.serve.protocol.EngineProtocol`) on
        ``device``; ``runtime`` makes a router's transfers a phase of
        that ``RollMuxRuntime``."""
        dcfg = self.disagg_config(batch=batch, max_seq_len=max_seq_len,
                                  eos_id=eos_id, temperature=temperature)
        if dcfg is not None:
            return DisaggRouter(model, params, dcfg, device=device,
                                generator=generator, policy=policy,
                                runtime=runtime, job_id=self.job_id)
        return Engine(model, params, self.engine_config(
            batch=batch, max_seq_len=max_seq_len, eos_id=eos_id,
            temperature=temperature), device=device, policy=policy,
            generator=generator)

    # ---- argparse bridge ---------------------------------------------------
    @classmethod
    def from_args(cls, args, **overrides) -> "RolloutSpec":
        """A spec from a launch entry point's argparse namespace (both
        ``launch/serve.py``'s and ``launch/train.py``'s).  Flags a parser
        lacks fall back to the spec's defaults; ``overrides`` win."""
        def get(*names, default=None):
            for n in names:
                if getattr(args, n, None) is not None:
                    return getattr(args, n)
            return default

        disagg = None
        if getattr(args, "disagg", False):
            disagg = {k: getattr(args, k) for k in (
                "prefill_slots", "decode_slots", "prefill_kv_blocks",
                "decode_kv_blocks", "prefill_engines", "kv_routing")
                if getattr(args, k, None) is not None} or True
        spec = cls(
            num_slots=get("slots", "num_slots"),
            block_size=get("block_size", "engine_block_size", default=1),
            kv_layout=get("kv", "kv_layout", default="contiguous"),
            kv_block_size=get("kv_block_size", default=16),
            num_kv_blocks=get("num_kv_blocks"),
            sched=get("sched", default="fifo"),
            prefix_share=bool(getattr(args, "prefix_share", False)),
            kv_dtype=get("kv_dtype"),
            disagg=disagg,
            group=get("group"),
            carry=bool(getattr(args, "carry", False)))
        return spec.replace(**overrides) if overrides else spec
