"""Rollout phase served by the continuous-batching engine.

Counterpart of ``repro/rl/rollout.py`` ``generate_continuous`` (greedy and
sampled decoding) and ``completions_to_text``.  The engine shape is given
as plain keyword arguments; the JAX package's ``RolloutSpec`` comes with
the disaggregated-serving slice, the static ``generate`` scan with
``stack_decode_step`` (ROADMAP).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data import tokenizer as tok
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.request import Request, RequestOutput


@dataclass(frozen=True)
class SamplerConfig:
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 => greedy (the JAX default is 1.0)
    eos_id: int = tok.EOS


def build_engine(model, params, *, max_seq_len: int, eos_id: int = tok.EOS,
                 temperature: float = 0.0, num_slots: int = 8,
                 block_size: int = 1, kv_layout: str = "contiguous",
                 kv_block_size: int = 16, num_kv_blocks: int | None = None,
                 sched: str = "fifo", kv_dtype: str | None = None,
                 policy=None, device=None, generator=None) -> Engine:
    """An :class:`Engine` from plain engine-shape keyword arguments;
    ``generator`` feeds sampled decoding."""
    return Engine(model, params, EngineConfig(
        num_slots=num_slots, max_seq_len=max_seq_len, eos_id=eos_id,
        temperature=temperature, block_size=block_size, kv_layout=kv_layout,
        kv_block_size=kv_block_size, num_kv_blocks=num_kv_blocks,
        sched=sched, kv_dtype=kv_dtype), device=device, policy=policy,
        generator=generator)


def run_requests(engine: Engine, requests) -> list[RequestOutput]:
    """Backpressure-aware drive: submit while the queue takes requests,
    step until everything finished; outputs sorted by rid."""
    pending = deque(requests)
    while pending or not engine.idle:
        while pending and engine.submit(pending[0]):
            pending.popleft()
        if not engine.idle:
            engine.step()
    return [engine.finished[r] for r in sorted(engine.finished)]


def generate_continuous(model, params, prompts, sampler: SamplerConfig, *,
                        generator=None, num_slots: int | None = None,
                        device=None, **engine_kw) -> dict:
    """Serve each row of ``prompts (B, Sp)`` as one request through the
    engine (``num_slots`` KV slots, default one per row; fewer slots than
    rows queue and recycle).  Sampled decoding (``sampler.temperature >
    0``) draws from ``generator``, a ``torch.Generator`` on ``device``,
    where the JAX package takes a key.  ``engine_kw`` are
    :func:`build_engine`'s engine-shape arguments (``block_size``, ``kv_layout``,
    ``kv_block_size``, ``num_kv_blocks``, ``sched``, ``policy``,
    ``kv_dtype``).

    Returns the JAX package's output dict as tensors on ``device``:
    ``completions``/``behavior_logp``/``mask`` ``(B, T)`` with T =
    ``max_new_tokens`` (EOS-filled / zero past each row's length),
    ``prompts``, ``tokens`` (prompt + completion) and ``engine_stats``."""
    prompts_np = np.asarray(prompts, np.int32)
    B, Sp = prompts_np.shape
    T = sampler.max_new_tokens
    engine = build_engine(
        model, params, max_seq_len=Sp + T, eos_id=sampler.eos_id,
        temperature=sampler.temperature,
        num_slots=B if num_slots is None else num_slots, device=device,
        generator=generator, **engine_kw)
    outs = run_requests(engine, (Request(rid=i, prompt=prompts_np[i],
                                         max_new_tokens=T)
                                 for i in range(B)))
    completions = np.full((B, T), sampler.eos_id, np.int32)
    behavior_logp = np.zeros((B, T), np.float32)
    mask = np.zeros((B, T), np.float32)
    for o in outs:
        n = o.num_tokens
        completions[o.rid, :n] = o.tokens
        behavior_logp[o.rid, :n] = o.logprobs
        mask[o.rid, :n] = 1.0
    dev = engine.device
    prompts_t = torch.from_numpy(prompts_np).to(dev)
    completions_t = torch.from_numpy(completions).to(dev)
    return {
        "prompts": prompts_t,
        "completions": completions_t,
        "tokens": torch.cat([prompts_t, completions_t], dim=1),
        "behavior_logp": torch.from_numpy(behavior_logp).to(dev),
        "mask": torch.from_numpy(mask).to(dev),
        "engine_stats": engine.stats,
    }


def completions_to_text(completions, mask) -> list[str]:
    """Decode each row's recorded tokens (mask > 0, EOS dropped)."""
    out = []
    for row, m in zip(np.asarray(completions), np.asarray(mask)):
        ids = [int(t) for t, mi in zip(row, m) if mi > 0 and int(t) != tok.EOS]
        out.append(tok.decode(ids))
    return out
