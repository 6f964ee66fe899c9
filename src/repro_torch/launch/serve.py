"""Serving driver: the continuous-batching engine on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --kv paged --kv-dtype int8 --batch 8 --slots 4 --max-new 32

Runs on the CUDA card at the architecture's full width with random
weights from ``--seed``; ``--reduced`` serves the smoke-test variant and
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.rl.rollout import build_engine, run_requests
from repro_torch.serve.request import Request


def serve_continuous(arch: str, prompts, *, reduced: bool = False,
                     max_new: int = 32, seed: int = 0,
                     num_slots: int | None = None, block_size: int = 1,
                     kv: str = "contiguous", kv_block_size: int = 16,
                     num_kv_blocks: int | None = None, sched: str = "fifo",
                     kv_dtype: str | None = None,
                     max_seq_len: int | None = None, device=None,
                     model=None, params=None) -> dict:
    """Serve ``prompts`` (sequences of token ids, ragged lengths allowed),
    one request each, through the continuous-batching engine with greedy
    decoding.  ``num_slots`` defaults to one per prompt; ``max_seq_len`` to
    the longest prompt plus ``max_new``.  Params default to the model's
    random init from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the CUDA card unless ``device="cpu"``).

    Returns a report: ``outputs`` (``RequestOutput`` by rid), ``texts``,
    ``wall_s``, ``tokens``, ``tok_per_s``, engine counters, and the
    drained ``engine`` itself."""
    dev = resolve_device(device)
    if model is None:
        model = build_model(arch, reduced=reduced)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if max_seq_len is None:
        max_seq_len = max(len(p) for p in prompts) + max_new
    engine = build_engine(
        model, params, max_seq_len=max_seq_len, eos_id=tok.EOS,
        num_slots=len(prompts) if num_slots is None else num_slots,
        block_size=block_size, kv_layout=kv, kv_block_size=kv_block_size,
        num_kv_blocks=num_kv_blocks, sched=sched, kv_dtype=kv_dtype,
        device=dev)
    t0 = time.perf_counter()
    outs = run_requests(engine, (Request(rid=i, prompt=p,
                                         max_new_tokens=max_new)
                                 for i, p in enumerate(prompts)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(o.num_tokens for o in outs)
    s = engine.stats
    return {"outputs": outs,
            "texts": [tok.decode(t for t in o.tokens if t != tok.EOS)
                      for o in outs],
            "wall_s": dt, "tokens": n_tok,
            "tok_per_s": n_tok / max(dt, 1e-9),
            "slot_utilization": s.slot_utilization,
            "prefills": s.prefills, "decode_steps": s.steps,
            "decode_time_s": s.decode_time_s,
            "peak_active": s.peak_active,
            "peak_kv_blocks": s.peak_kv_blocks,
            "engine": engine}


def _main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
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
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    texts = [f"{i}+{i + 1}=" for i in range(args.batch)]
    res = serve_continuous(
        args.arch, [tok.encode(t, bos=True) for t in texts],
        reduced=args.reduced, max_new=args.max_new, seed=args.seed,
        num_slots=args.slots, block_size=args.block_size, kv=args.kv,
        kv_block_size=args.kv_block_size, num_kv_blocks=args.num_kv_blocks,
        sched=args.sched, kv_dtype=args.kv_dtype, device=args.device)
    dev = res["engine"].device
    print(f"[continuous] served {len(texts)} requests on {dev}, "
          f"{res['tokens']} tokens in {res['wall_s']:.2f}s "
          f"({res['tok_per_s']:.1f} tok/s, slot util "
          f"{res['slot_utilization']:.0%}, {res['decode_steps']} decode "
          f"steps)")
    for p, t in zip(texts, res["texts"]):
        print(f"  {p!r} -> {t!r}")


if __name__ == "__main__":
    _main()
