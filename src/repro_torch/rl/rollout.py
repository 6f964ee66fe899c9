"""Rollout phase: the static batch :func:`generate` and the rollouts
served by the continuous-batching engine.

Counterpart of ``repro/rl/rollout.py``: ``generate`` (prefill once, then
one decode step of the whole batch per token), ``generate_continuous``
(greedy and sampled decoding), ``generate_continuous_stream`` (with
``sync_params``, partial-rollout continuation across weight syncs) and
``completions_to_text``.  The engine shape is a
:class:`~repro_torch.serve.spec.RolloutSpec` (``spec=``), which selects
radix prefix sharing and disaggregated prefill/decode serving too, or
the same fields as plain keyword arguments.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.serve.engine import Engine, sample_logp
from repro_torch.serve.request import Request, RequestOutput
from repro_torch.serve.spec import RolloutSpec


@dataclass(frozen=True)
class SamplerConfig:
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 => greedy (the JAX default is 1.0)
    eos_id: int = tok.EOS


@torch.no_grad()
def generate(model, params, prompts, sampler: SamplerConfig, *,
             generator=None, frontend=None) -> dict:
    """prompts ``(B, Sp)`` int -> the JAX package's ``generate`` dict on
    the weights' device: ``prompts``, ``completions`` and
    ``behavior_logp`` ``(B, T)`` (T = ``max_new_tokens``), ``tokens``
    (prompt + completion) and ``mask`` ``(B, T)`` float32, 1 up to and
    including each row's first EOS.

    The static rollout: one prefill of the whole batch, then T decode
    steps of every row (``Model.decode_step`` over a contiguous cache
    with one shared position; the decode attention kernel on the card).
    A row runs its full T tokens whatever it samples; the mask keeps
    what a fixed-budget rollout records.  Sampling is :func:`sample_logp`
    (the engine's): the greedy kernel at temperature 0, above it a
    Gumbel-max draw from ``generator`` (a ``torch.Generator`` on the
    weights' device), where the JAX package takes a key.  ``frontend``
    (``(B, F, d)``, a numpy array or a tensor) is the batch's vision or
    audio embeddings, as ``Model.prefill`` takes them."""
    dev = params["embed"].device
    prompts_t = torch.as_tensor(np.asarray(prompts, np.int32)).to(dev)
    B, Sp = prompts_t.shape
    T = sampler.max_new_tokens
    cache = model.init_cache(B, Sp + T, device=dev)
    logits, cache = model.prefill(
        params, prompts_t, cache,
        frontend=None if frontend is None else torch.as_tensor(
            frontend).to(dev))
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    toks, logps, masks = [], [], []
    for _ in range(T):
        nxt, logp = sample_logp(logits, sampler.temperature,
                                generator=generator)
        logits, cache = model.decode_step(params, nxt[:, None], cache)
        masks.append(alive.float())
        alive = alive & (nxt != sampler.eos_id)
        toks.append(nxt)
        logps.append(logp)
    completions = torch.stack(toks, dim=1)
    return {"prompts": prompts_t,
            "completions": completions,
            "tokens": torch.cat([prompts_t, completions], dim=1),
            "behavior_logp": torch.stack(logps, dim=1),
            "mask": torch.stack(masks, dim=1)}


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


def _resolve_spec(spec, num_slots, engine_kw) -> tuple:
    """``(spec, policy)`` from a call's ``spec`` or its engine-shape
    keyword arguments (``RolloutSpec``'s fields, and ``policy``); both
    at once raise."""
    policy = engine_kw.pop("policy", None)
    if spec is None:
        return RolloutSpec(num_slots=num_slots, **engine_kw), policy
    if engine_kw or num_slots is not None:
        raise ValueError(
            f"spec= given alongside engine-shape kwargs "
            f"{sorted(engine_kw) + (['num_slots'] if num_slots else [])}; "
            f"move them into the RolloutSpec")
    return spec, policy


def _engine_session(model, params, prompts_np, sampler: SamplerConfig, *,
                    engine, generator, device, spec, policy, frontend=None):
    """Shared engine setup of the batch and streaming rollouts: build the
    engine ``spec`` describes, or check and ``reset`` a persistent
    (drained) one with ``params`` and ``generator``; then the prompt rows
    as the pending request deque, in ``spec.prefix_namespace``, row i
    with ``frontend[i:i + 1]`` when a frontend ``(B, F, d)`` is given."""
    B, Sp = prompts_np.shape
    T = sampler.max_new_tokens
    if engine is None:
        engine = spec.build_engine(
            model, params, batch=B, max_seq_len=Sp + T,
            eos_id=sampler.eos_id, temperature=sampler.temperature,
            generator=generator, policy=policy, device=device)
    else:
        cfg = engine.config
        if cfg.max_seq_len < Sp + T:
            raise ValueError(f"persistent engine max_seq_len "
                             f"{cfg.max_seq_len} < prompt {Sp} + budget {T}")
        # sampling, layout and KV dtype are fixed when the engine is
        # built: a request that disagrees would be served the engine's own
        # configuration, so refuse it
        if (cfg.temperature, cfg.eos_id) != (sampler.temperature,
                                             sampler.eos_id):
            raise ValueError(
                f"persistent engine serves temperature={cfg.temperature}, "
                f"eos_id={cfg.eos_id} but the sampler asks for "
                f"temperature={sampler.temperature}, eos_id={sampler.eos_id}")
        if cfg.kv_layout != spec.kv_layout:
            raise ValueError(f"persistent engine kv_layout="
                             f"{cfg.kv_layout!r} != requested "
                             f"{spec.kv_layout!r}")
        want, have = (None if d == "auto" else d for d in (
            spec.kv_dtype, cfg.kv_dtype))
        if have != want:
            raise ValueError(f"persistent engine kv_dtype={have!r} != "
                             f"requested {want!r}")
        if spec.prefix_share and not cfg.prefix_share:
            raise ValueError("persistent engine was built without "
                             "prefix_share")
        if device is not None and resolve_device(device) != engine.device:
            raise ValueError(f"persistent engine runs on {engine.device}, "
                             f"not {device}")
        engine.reset(params, generator)
    pending = deque(Request(rid=i, prompt=prompts_np[i], max_new_tokens=T,
                            frontend=(None if frontend is None
                                      else frontend[i:i + 1]),
                            prefix_key=spec.prefix_namespace,
                            job_id=spec.job_id)
                    for i in range(B))
    return engine, pending


def _pack(outs, n_rows: int, T: int, eos_id: int, row_of):
    """Completions (EOS-filled), behaviour logprobs, mask and per-token
    weight versions (zero-filled, and -1 past each row's length) as
    ``(n_rows, T)`` numpy arrays; ``row_of(o)`` places each output."""
    completions = np.full((n_rows, T), eos_id, np.int32)
    behavior_logp = np.zeros((n_rows, T), np.float32)
    mask = np.zeros((n_rows, T), np.float32)
    token_versions = np.full((n_rows, T), -1, np.int32)
    for o in outs:
        r, n = row_of(o), o.num_tokens
        completions[r, :n] = o.tokens
        behavior_logp[r, :n] = o.logprobs
        mask[r, :n] = 1.0
        token_versions[r, :n] = o.token_versions
    return completions, behavior_logp, mask, token_versions


def generate_continuous(model, params, prompts, sampler: SamplerConfig, *,
                        spec: RolloutSpec | None = None, generator=None,
                        frontend=None, num_slots: int | None = None,
                        device=None, engine: Engine | None = None,
                        **engine_kw) -> dict:
    """Serve each row of ``prompts (B, Sp)`` as one request through the
    engine (``num_slots`` KV slots, default one per row; fewer slots than
    rows queue and recycle).  Sampled decoding (``sampler.temperature >
    0``) draws from ``generator``, a ``torch.Generator`` on ``device``,
    where the JAX package takes a key.  The engine's shape is ``spec``
    (a :class:`~repro_torch.serve.spec.RolloutSpec`), or ``num_slots``
    and ``engine_kw``, its fields as keyword arguments (``block_size``,
    ``kv_layout``, ``kv_block_size``, ``num_kv_blocks``, ``sched``,
    ``prefix_share``, ``kv_dtype``, ``disagg``, ...), plus ``policy``;
    ``spec`` and those at once raise.  ``frontend`` ``(B, F, d)`` gives
    row i the request frontend ``frontend[i:i + 1]`` (vlm, audio: such
    requests never share a radix prefix).  ``prefix_share=True`` (paged)
    serves GRPO's duplicated rows from one prefill each; ``disagg``
    serves through a ``DisaggRouter``, with the same output bit for bit
    when its decode pool has the monolithic engine's slot count.

    ``engine`` reuses a persistent, drained engine across calls (the mux
    trainer's rollout actor): ``Engine.reset`` swaps in ``params`` (and
    ``generator``, when given) and serves from the existing slot pool.  An
    engine whose ``max_seq_len`` is too short, or whose sampling,
    ``kv_layout`` or ``kv_dtype`` disagree with the request, is refused.

    Returns the JAX package's output dict as tensors on the engine's
    device: ``completions``/``behavior_logp``/``mask`` ``(B, T)`` with T =
    ``max_new_tokens`` (EOS-filled / zero past each row's length),
    ``prompts``, ``tokens`` (prompt + completion), ``token_versions`` (a
    numpy ``(B, T)`` array of the engine weight version each token was
    sampled under, -1 past each row's length) and ``engine_stats``, the
    engine's :meth:`~repro_torch.serve.engine.Engine.metrics` after this
    call (a ``core.telemetry.MetricsSnapshot`` of its work only)."""
    prompts_np = np.asarray(prompts, np.int32)
    B = prompts_np.shape[0]
    T = sampler.max_new_tokens
    spec, policy = _resolve_spec(spec, num_slots, engine_kw)
    engine, pending = _engine_session(
        model, params, prompts_np, sampler, engine=engine,
        generator=generator, device=device, spec=spec, policy=policy,
        frontend=frontend)
    outs = run_requests(engine, pending)
    with telemetry.span("rollout.pack"):
        completions, behavior_logp, mask, token_versions = _pack(
            outs, B, T, sampler.eos_id, lambda o: o.rid)
        dev = engine.device
        prompts_t = torch.from_numpy(prompts_np).to(dev)
        completions_t = torch.from_numpy(completions).to(dev)
        return {
            "prompts": prompts_t,
            "completions": completions_t,
            "tokens": torch.cat([prompts_t, completions_t], dim=1),
            "behavior_logp": torch.from_numpy(behavior_logp).to(dev),
            "mask": torch.from_numpy(mask).to(dev),
            "token_versions": token_versions,
            "engine_stats": engine.metrics(),
        }


def generate_continuous_stream(model, params, prompts,
                               sampler: SamplerConfig, *,
                               spec: RolloutSpec | None = None,
                               group: int | None = None, sync_params=None,
                               generator=None, frontend=None,
                               num_slots: int | None = None,
                               device=None, engine: Engine | None = None,
                               **engine_kw):
    """Yield completed GRPO prompt groups (``group`` consecutive rows; each
    row its own group when ``group`` is None or 1) the moment their last
    member finishes decoding, while the engine keeps serving the
    stragglers: the engine is drained through :meth:`Engine.harvest`
    between scheduler ticks, never waited on.  ``group`` defaults to
    ``spec.group``.

    The same engine computation as :func:`generate_continuous` (same
    arguments): each yielded dict holds ``group_index`` (``rid //
    group``), ``rows`` (the group's row indices, ascending) and numpy
    ``(rows, T)`` arrays ``completions``, ``behavior_logp``, ``mask`` and
    ``token_versions`` with the batch call's padding, so stacking the
    groups by ``rows`` reproduces its arrays bit for bit.  Groups come in
    completion order.  Per-call telemetry is the engine's ``metrics()``
    once the generator is exhausted.

    ``sync_params`` is partial-rollout continuation across weight syncs:
    a callable returning ``(params, version)``, the newest synced weights,
    polled between scheduler ticks.  When the version moves mid-rollout
    the engine swaps them in live (``Engine.reset(carry_live=True)``:
    every in-flight generation is suspended, the weights swapped, the
    generations resumed with their outputs carried), so the stragglers
    finish on the new weights; ``token_versions`` says which weights
    sampled each token."""
    prompts_np = np.asarray(prompts, np.int32)
    B = prompts_np.shape[0]
    T = sampler.max_new_tokens
    spec, policy = _resolve_spec(spec, num_slots, engine_kw)
    g = group or spec.group or 1
    engine, pending = _engine_session(
        model, params, prompts_np, sampler, engine=engine,
        generator=generator, device=device, spec=spec, policy=policy,
        frontend=frontend)
    synced_version = None
    if sync_params is not None:
        _, synced_version = sync_params()   # the session's baseline
    sizes = [min(B, (gi + 1) * g) - gi * g for gi in range(-(-B // g))]
    buckets: dict[int, list[RequestOutput]] = {}

    def drain_finished():
        for o in engine.harvest():
            gi = o.rid // g
            buckets.setdefault(gi, []).append(o)
            if len(buckets[gi]) == sizes[gi]:
                outs = sorted(buckets.pop(gi), key=lambda o: o.rid)
                completions, behavior_logp, mask, token_versions = _pack(
                    outs, len(outs), T, sampler.eos_id,
                    lambda o: o.rid - gi * g)
                yield {"group_index": gi, "rows": [o.rid for o in outs],
                       "completions": completions,
                       "behavior_logp": behavior_logp, "mask": mask,
                       "token_versions": token_versions}

    def maybe_carry_sync():
        nonlocal synced_version
        if sync_params is None:
            return
        new_params, version = sync_params()
        if version != synced_version:
            synced_version = version
            engine.reset(new_params, carry_live=True)

    # backpressure-aware drive, harvesting between scheduler ticks
    while pending or not engine.idle:
        while pending and engine.submit(pending[0]):
            pending.popleft()
        if not engine.idle:
            engine.step()
        yield from drain_finished()
        maybe_carry_sync()
    yield from drain_finished()


def completions_to_text(completions, mask) -> list[str]:
    """Decode each row's recorded tokens (mask > 0, EOS dropped)."""
    out = []
    for row, m in zip(np.asarray(completions), np.asarray(mask)):
        ids = [int(t) for t, mi in zip(row, m) if mi > 0 and int(t) != tok.EOS]
        out.append(tok.decode(ids))
    return out
