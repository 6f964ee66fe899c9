"""Serving drivers: the continuous-batching engine (default), its elastic
form, and the static batch on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --kv paged --kv-dtype int8 --batch 8 --slots 4 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --kv paged \
        --prefix-share --group 4              # GRPO-shaped radix sharing
    PYTHONPATH=src python -m repro_torch.launch.serve --disagg \
        --prefill-slots 2 --decode-slots 6    # split prefill/decode pools
    PYTHONPATH=src python -m repro_torch.launch.serve --engine elastic \
        --ladder 2,4,8 [--shed --deadline-s 2]   # closed-loop capacity
    PYTHONPATH=src python -m repro_torch.launch.serve --engine static \
        --batch 8 --max-new 32                # one prefill, fixed decode

``--arch`` takes internlm2-1.8b, gemma3-4b (sliding-window layers),
minitron-8b, qwen2.5-32b, qwen2-vl-7b (M-RoPE, vision embeddings),
whisper-tiny (an encoder and cross-attention), dbrx-132b (16 experts, top
4), deepseek-v2-236b (MLA, 160 experts top 6, 2 shared), rwkv6-7b or
zamba2-2.7b, on
every layout (rwkv6 has no paged leaf: ``--kv paged`` serves it with zero
blocks a request, and ``--kv-dtype int8`` raises).  qwen2-vl-7b and
whisper-tiny requests carry a zero frontend, as the JAX CLI's: a vision
request's prompt leads with ``num_frontend_tokens`` placeholder ids that
the embeddings overlay, an audio request carries ``max_source_len``
frames.  Runs on the CUDA card at the
architecture's full width with random weights from ``--seed``;
``--reduced`` serves the smoke-test variant and ``--device cpu`` runs the
kernels' plain versions on the CPU.  dbrx-132b at full width holds 131.6 B
parameters, 263 GB in bf16, more than one 80 GB card: serve it with
``--reduced`` (the CLI cuts no depth).  Its MoE layers route a decode
step's slots together under a capacity, so a request's tokens depend on
the requests it shares the pool with.  deepseek-v2-236b at full width
holds 235.7 B parameters, 471 GB in bf16: serve it with ``--reduced``
too.  Its engine routes each slot's MoE rows alone, as the JAX engine's
per-slot step does, so its decode drops nothing.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.rl.rollout import (SamplerConfig, completions_to_text,
                                    generate, run_requests)
from repro_torch.serve.request import Request
from repro_torch.serve.spec import RolloutSpec


def cli_frontend(cfg, prompt):
    """``(prompt, frontend)`` of a CLI request for ``cfg``: a vlm's prompt
    with ``num_frontend_tokens`` placeholder ids (0) in front and a zero
    ``(1, F, d)`` frontend over them, an audio model's prompt with zero
    ``(1, max_source_len, d)`` frames, a text model's prompt alone."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if cfg.frontend == "vision":
        F = cfg.num_frontend_tokens
        return (np.concatenate([np.zeros(F, np.int32), prompt]),
                np.zeros((1, F, cfg.d_model), np.float32))
    if cfg.frontend == "audio":
        return prompt, np.zeros((1, cfg.max_source_len, cfg.d_model),
                                np.float32)
    return prompt, None


def _encode_prompts(model, prompts_text, device):
    """Text prompts -> ``(prompts, frontend)``: each prompt byte-encoded
    with a BOS and padded to the longest (a ``(B, P)`` int32 numpy array,
    as ``generate`` takes it), and a zero float32 frontend on ``device``
    for a vlm ``(B, num_frontend_tokens, d)`` or an audio model ``(B,
    max_source_len, d)``, else None, as the JAX package's static path
    builds them."""
    ids = [tok.encode(t, bos=True) for t in prompts_text]
    prompts = tok.pad_batch(ids, max(len(i) for i in ids))
    cfg, B = model.cfg, len(ids)
    fr = None
    if cfg.frontend == "vision":
        fr = torch.zeros((B, cfg.num_frontend_tokens, cfg.d_model),
                         device=device)
    elif cfg.frontend == "audio":
        fr = torch.zeros((B, cfg.max_source_len, cfg.d_model),
                         device=device)
    return prompts, fr


def serve_batch(arch: str, prompts_text: list[str], *, reduced: bool = False,
                max_new: int = 32, temperature: float = 0.8, seed: int = 0,
                generator: torch.Generator | None = None, device=None,
                model=None, params=None) -> dict:
    """Static batch: one prefill of the whole batch (flash attention on the
    card), then ``max_new`` decode steps of every row through
    ``rl.rollout.generate`` (decode attention on the card; the greedy
    kernel at temperature 0): every request pays ``max_new`` steps
    whatever it samples.  Params default to the model's random init from a
    ``torch.Generator`` seeded with ``seed``; sampling draws from
    ``generator`` (default: another seeded with ``seed``), where the JAX
    package takes a key.  ``device`` is the CUDA card unless
    ``device="cpu"``; with no card and no device it raises.

    Returns the JAX package's dict (``texts``, ``wall_s``, ``tokens``,
    ``tok_per_s``) with ``completions``, ``logprobs`` and ``mask`` (``(B,
    max_new)``, on the CPU) beside it."""
    dev = resolve_device(device)
    if model is None:
        model = build_model(arch, reduced=reduced)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    prompts, fr = _encode_prompts(model, prompts_text, dev)
    sampler = SamplerConfig(max_new_tokens=max_new, temperature=temperature)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, sampler, generator=generator,
                   frontend=fr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    comp, logp, mask = (out[k].cpu() for k in ("completions",
                                               "behavior_logp", "mask"))
    n_tok = int(mask.sum())
    return {"texts": completions_to_text(comp, mask), "wall_s": dt,
            "tokens": n_tok, "tok_per_s": n_tok / max(dt, 1e-9),
            "completions": comp, "logprobs": logp, "mask": mask}


def serve_continuous(arch: str, prompts, *, reduced: bool = False,
                     max_new: int = 32, seed: int = 0,
                     spec: RolloutSpec | None = None,
                     num_slots: int | None = None, block_size: int = 1,
                     kv: str = "contiguous", kv_block_size: int = 16,
                     num_kv_blocks: int | None = None, sched: str = "fifo",
                     kv_dtype: str | None = None, prefix_share: bool = False,
                     disagg=None, max_seq_len: int | None = None,
                     device=None, model=None, params=None,
                     frontends=None) -> dict:
    """Serve ``prompts`` (sequences of token ids, ragged lengths allowed),
    one request each, through the continuous-batching engine with greedy
    decoding.  The engine's shape is ``spec`` or the loose arguments (a
    :class:`~repro_torch.serve.spec.RolloutSpec`'s fields): ``num_slots``
    defaults to one per prompt, ``prefix_share`` (paged) turns on radix
    prefix sharing and ``disagg`` (``True`` or a dict of ``DisaggConfig``
    fields) serves through a ``DisaggRouter``.  ``max_seq_len`` defaults
    to the longest prompt plus ``max_new``.  Params default to the model's
    random init from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the CUDA card unless ``device="cpu"``).  ``frontends``
    gives request i the frontend ``frontends[i]`` (vlm, audio).

    Returns a report: ``outputs`` (``RequestOutput`` by rid), ``texts``,
    ``wall_s``, ``tokens``, ``tok_per_s``, ``ttft_mean_s`` (every request
    arrives at the start), the engine's counters (``metrics()``: prefix
    hits, partial hits, misses and blocks saved; with ``disagg`` the
    transfers, their host seconds and ``transfer_overhead_frac``), the
    decode engine's CUDA graph captures and their host seconds, and the
    drained ``engine`` itself."""
    if spec is None:
        spec = RolloutSpec(num_slots=num_slots, block_size=block_size,
                           kv_layout=kv, kv_block_size=kv_block_size,
                           num_kv_blocks=num_kv_blocks, sched=sched,
                           kv_dtype=kv_dtype, prefix_share=prefix_share,
                           disagg=disagg)
    dev = resolve_device(device)
    if model is None:
        model = build_model(arch, reduced=reduced)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if max_seq_len is None:
        max_seq_len = max(len(p) for p in prompts) + max_new
    engine = spec.build_engine(model, params, batch=len(prompts),
                               max_seq_len=max_seq_len, eos_id=tok.EOS,
                               temperature=0.0, device=dev)
    t0 = time.perf_counter()
    engine.clock = lambda: time.perf_counter() - t0
    outs = run_requests(engine, (Request(
        rid=i, prompt=p, max_new_tokens=max_new,
        frontend=None if frontends is None else frontends[i],
        prefix_key=spec.prefix_namespace) for i, p in enumerate(prompts)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    engine.clock = None
    n_tok = sum(o.num_tokens for o in outs)
    s = engine.metrics()
    decode = getattr(engine, "decode", engine)
    report = {"outputs": outs,
            "texts": [tok.decode(t for t in o.tokens if t != tok.EOS)
                      for o in outs],
            "wall_s": dt, "tokens": n_tok,
            "tok_per_s": n_tok / max(dt, 1e-9),
            "slot_utilization": s.slot_utilization,
            "prefills": s.prefills, "decode_steps": s.steps,
            "decode_time_s": s.decode_time_s,
            "peak_active": s.peak_active,
            "peak_kv_blocks": s.peak_kv_blocks,
            "ttft_mean_s": float(np.mean([o.first_token_time
                                          for o in outs])),
            "prefix_hits": s.prefix_hits,
            "prefix_partial_hits": s.prefix_partial_hits,
            "prefix_misses": s.prefix_misses,
            "blocks_saved": s.blocks_saved,
            "captures": decode.captures, "capture_s": decode.capture_s,
            "engine": engine}
    if spec.disagg:
        report.update(transfers=s.transfers,
                      transfer_time_s=s.transfer_time_s,
                      transferred_blocks=s.transferred_blocks,
                      transfer_overhead_frac=s.transfer_overhead_frac)
    return report


def serve_elastic(arch: str, prompts, *, reduced: bool = False,
                  max_new: int = 32, seed: int = 0,
                  spec: RolloutSpec | None = None,
                  ladder: tuple = (2, 4, 8), shed: bool = False,
                  deadline_s: float = 2.0, arrival_gap_s: float = 0.05,
                  max_seq_len: int | None = None, device=None, model=None,
                  params=None, frontends=None) -> dict:
    """Closed-loop elastic serving: replay a staggered arrival trace
    (request ``i`` arrives at ``i * arrival_gap_s``) through
    ``serve.run_trace(realtime=False)`` with an ``ElasticController`` in
    the loop.

    The engine starts on the smallest rung of ``ladder`` and the
    controller grows or shrinks it between steps by suspend/resume (live
    KV carried, greedy tokens identical to a static run).  ``shed=True``
    gives every request the deadline ``arrival + deadline_s`` and arms the
    admission gate: a request that cannot meet its deadline is degraded
    (decode budget clamped) before it is shed, and every shed is recorded
    in the report.  Returns the ``run_trace`` report (its ``"elastic"``
    section: capacity-seconds, sheds and degrades, the resize history; its
    ``"engine"``: the engine it ended on) with ``texts``.  ``frontends``
    gives request i the frontend ``frontends[i]`` (vlm, audio).

    The JAX package warms every rung up, compiling its decode shape before
    the trace; otherwise the first step's compile lands in
    ``decode_time_s``, the admission predictor reads an inflated time per
    token and an unloaded system sheds like a saturated one.  On the card
    the counterpart of that compile is the CUDA graph capture of each new
    engine's decode block: the starting engine and every resized one run
    :meth:`~repro_torch.serve.engine.Engine.warm_up` on their empty pool,
    and capture on their first tick with work before its timed window, so
    neither lands in ``decode_time_s``."""
    from repro_torch.serve.elastic import ElasticConfig, ElasticController
    from repro_torch.serve.engine import run_trace

    dev = resolve_device(device)
    if model is None:
        model = build_model(arch, reduced=reduced)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    ladder = tuple(sorted({int(x) for x in ladder}))
    if spec is None:
        spec = RolloutSpec()
    spec = spec.replace(num_slots=ladder[0])
    toks = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if max_seq_len is None:
        max_seq_len = max(len(t) for t in toks) + max_new
    engine = spec.build_engine(model, params, batch=len(toks),
                               max_seq_len=max_seq_len, eos_id=tok.EOS,
                               temperature=0.0, device=dev)
    getattr(engine, "decode", engine).warm_up()
    reqs = []
    for i, t in enumerate(toks):
        arrival = i * arrival_gap_s
        reqs.append(Request(rid=i, prompt=t, max_new_tokens=max_new,
                            arrival_time=arrival,
                            frontend=(None if frontends is None
                                      else frontends[i]),
                            deadline=arrival + deadline_s if shed else None))
    controller = ElasticController(ElasticConfig(
        ladder=ladder, shed=shed, interval_s=0.05, cooldown_s=0.15))
    report = run_trace(engine, reqs, realtime=False, controller=controller)
    report["texts"] = [tok.decode(t for t in o.tokens if t != tok.EOS)
                       for o in report["outputs"]]
    return report


def _main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--engine", choices=("continuous", "static",
                                         "elastic"),
                    default="continuous",
                    help="continuous = a fixed slot pool; static = one "
                         "batch: one prefill, then max-new decode steps of "
                         "every row (rl.rollout.generate, temperature "
                         "0.8); elastic = the continuous engine under the "
                         "closed-loop capacity controller (serve.elastic), "
                         "replaying a staggered arrival trace")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the smoke-test variant (2 layers, fp32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=None,
                    help="KV-cache slots (default = batch)")
    ap.add_argument("--block-size", type=int, default=1,
                    help="decode steps per scheduler tick")
    ap.add_argument("--kv", choices=("contiguous", "paged"),
                    default="contiguous", help="KV-cache layout")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV block (--kv paged)")
    ap.add_argument("--num-kv-blocks", type=int, default=None,
                    help="paged pool size in blocks (default: same memory "
                         "as the contiguous slot pool)")
    ap.add_argument("--sched", choices=("fifo", "deadline", "slo"),
                    default="fifo", help="admission policy")
    ap.add_argument("--kv-dtype", choices=("auto", "int8"), default=None,
                    help="paged KV storage dtype (--kv paged)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="radix prompt-prefix KV sharing (--kv paged): "
                         "requests agreeing on a block-aligned token "
                         "prefix share those blocks, exact repeats skip "
                         "prefill")
    ap.add_argument("--group", type=int, default=None,
                    help="each prompt is served group times (the GRPO "
                         "rollout shape)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: prefill engines hand the "
                         "finished KV to the decode engine by transfer "
                         "handle (output identical under greedy)")
    ap.add_argument("--prefill-slots", type=int, default=None,
                    help="prefill-side slots (--disagg; default slots/4, "
                         "min 1)")
    ap.add_argument("--decode-slots", type=int, default=None,
                    help="decode-side slots (--disagg; default slots - "
                         "prefill slots)")
    ap.add_argument("--prefill-kv-blocks", type=int, default=None,
                    help="prefill-side paged pool size (--disagg --kv "
                         "paged)")
    ap.add_argument("--decode-kv-blocks", type=int, default=None,
                    help="decode-side paged pool size (--disagg --kv "
                         "paged; default --num-kv-blocks)")
    ap.add_argument("--prefill-engines", type=int, default=None,
                    help="parallel prefill engines (--disagg; each with "
                         "its own pools and radix tree)")
    ap.add_argument("--kv-routing", choices=("kv_aware", "queue"),
                    default=None,
                    help="steering across --prefill-engines: kv_aware to "
                         "the engine holding the longest prefix, queue by "
                         "load alone")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ladder", default="2,4,8",
                    help="--engine elastic: comma-separated slot counts the "
                         "controller may resize between")
    ap.add_argument("--shed", action="store_true",
                    help="--engine elastic: give every request a deadline "
                         "and arm overload admission control (degrade the "
                         "decode budget before shedding; every shed "
                         "reported)")
    ap.add_argument("--deadline-s", type=float, default=2.0,
                    help="--engine elastic --shed: each request's deadline, "
                         "seconds after its arrival")
    args = ap.parse_args()
    spec = RolloutSpec.from_args(args)
    texts = [f"{i}+{i + 1}=" for i in range(args.batch)]
    if args.group:
        texts = [t for t in texts for _ in range(args.group)]
    cfg = build_model(args.arch, reduced=args.reduced).cfg
    prompts, frontends = zip(*(cli_frontend(cfg, tok.encode(t, bos=True))
                               for t in texts))
    frontends = None if cfg.frontend is None else list(frontends)
    if args.engine == "elastic":
        ladder = tuple(int(x) for x in args.ladder.split(","))
        res = serve_elastic(
            args.arch, prompts, reduced=args.reduced, max_new=args.max_new,
            seed=args.seed, spec=spec, ladder=ladder, shed=args.shed,
            deadline_s=args.deadline_s, device=args.device,
            frontends=frontends)
        e = res["elastic"]
        print(f"[elastic] served {len(res['outputs'])}/{len(texts)} "
              f"requests on {res['engine'].device}, {res['tokens']} tokens "
              f"in {res['makespan_s']:.2f}s ({res['tok_per_s']:.1f} tok/s)")
        print(f"  resizes {e['resizes']} "
              + "".join(f"{a}->{b} " for _, a, b in e["resize_log"])
              + f"| capacity {e['capacity_seconds']:.2f} slot-s "
              f"(static {e['static_capacity_seconds']:.2f}, ratio "
              f"{e['capacity_seconds_ratio']:.2f})")
        print(f"  sheds {e['sheds']}, degrades {e['degrades']}, classes "
              f"{e['class_counts']}")
        for o, t in zip(res["outputs"], res["texts"]):
            print(f"  rid={o.rid} [{o.finish_reason}] -> {t!r}")
        return
    if args.engine == "static":
        res = serve_batch(args.arch, texts, reduced=args.reduced,
                          max_new=args.max_new, seed=args.seed,
                          device=args.device)
        print(f"[static] served {len(texts)} requests, {res['tokens']} "
              f"tokens in {res['wall_s']:.2f}s ({res['tok_per_s']:.1f} "
              f"tok/s)")
        for p, t in zip(texts, res["texts"]):
            print(f"  {p!r} -> {t!r}")
        return
    res = serve_continuous(
        args.arch, prompts, reduced=args.reduced, max_new=args.max_new,
        seed=args.seed, spec=spec, device=args.device, frontends=frontends)
    dev = res["engine"].device
    extra = ""
    if args.prefix_share:
        extra += (f", {res['prefix_hits']} prefix hits, "
                  f"{res['prefix_partial_hits']} partial, "
                  f"{res['prefix_misses']} misses "
                  f"({res['blocks_saved']} blocks saved)")
    if args.disagg:
        extra += (f", {res['transfers']} KV transfers "
                  f"({res['transfer_overhead_frac']:.1%} overhead)")
    print(f"[continuous] served {len(texts)} requests on {dev}, "
          f"{res['tokens']} tokens in {res['wall_s']:.2f}s "
          f"({res['tok_per_s']:.1f} tok/s, slot util "
          f"{res['slot_utilization']:.0%}, {res['decode_steps']} decode "
          f"steps, {res['prefills']} prefills{extra})")
    for p, t in zip(texts, res["texts"]):
        print(f"  {p!r} -> {t!r}")


if __name__ == "__main__":
    _main()
