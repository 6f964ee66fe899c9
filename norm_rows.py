#!/usr/bin/env python3
"""Whether RMSNorm's mean of squares rounds a row the same at every row
count on one H100, and what each way of computing it costs a decode step.

    python3 norm_rows.py

A reduction on the card may split each row differently for different row
counts, so a decode step's norm could round a slot's row one way in an
engine of 4 slots and another in one of 8, and a greedy token flip where
two logits nearly tie: an elastic engine, which serves on 2, 4 and 8
slots, would then differ from a static one.  Each variant below computes
``models.common._mean_square`` (the mean of squares of the last axis,
keepdim, in float32); the script swaps it in and measures:

1. rows — for the widths the served models normalise (internlm2-1.8b's
   2048, zamba2-2.7b's 2560 and its gated norm's 5120, rwkv6-7b's 4096)
   and M in 1..8, 12, 15, 16, 32, 64, 128, 2048 rows of seeded bf16
   values cast to float32: how many of the first min(M, 8) rows differ,
   bit for bit, from the same rows computed at M 8 (a static engine's
   slot count) and, for M of 16 and more, at M 16.
2. norm — ``rms_norm`` alone: 49 calls (an internlm2 decode step's) on
   (8, 1, 2048) bf16 in one CUDA graph, median replay time of 50 by CUDA
   events.
3. step — ms per decode step (``decode_time_s / steps`` of a warm engine,
   replays only) of internlm2-1.8b (contiguous, paged bf16) and
   zamba2-2.7b (contiguous, paged bf16), 8 slots, the first 8 of
   ``chip_smoke.py``'s serve prompts at 64 new tokens; the variants run
   in order and again in reverse, both readings printed.
4. slots — internlm2-1.8b paged bf16, the 16 serve prompts at 128 new
   tokens through 2 and 4 slots against 8: the rids whose greedy tokens
   differ.

Writes ``chiprun_out/norm_rows.json``.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import chip_smoke
from chip_smoke import ARCH, MAX_NEW, MAX_SEQ, SLOTS, ZAMBA_ARCH

WIDTHS = {"internlm2 d_model": 2048, "zamba2 d_model": 2560,
          "zamba2 gated norm": 5120, "rwkv6 d_model": 4096}
ROWS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 15, 16, 32, 64, 128, 2048)
STEP_REQ, STEP_NEW = 8, 64


def _padded(rows_min: int):
    def mean_square(xf):
        import torch.nn.functional as F
        rows = xf.reshape(-1, xf.shape[-1])
        n = rows.shape[0]
        if n < rows_min:
            rows = F.pad(rows, (0, 0, 0, rows_min - n))
        return rows.pow(2).mean(-1)[:n].reshape(*xf.shape[:-1], 1)
    return mean_square


def _plain(xf):
    return xf.pow(2).mean(-1, keepdim=True)


def _two_stage(xf):
    d = xf.shape[-1]
    return xf.pow(2).unflatten(-1, (16, d // 16)).mean(-1).mean(
        -1, keepdim=True)


def variants() -> dict:
    """The plain mean, the rows padded to 64 or 16, 16 partial means and
    their mean at every row count, and the committed ``_mean_square``
    (that below 16 rows, the plain mean from 16 on)."""
    from repro_torch.models import common
    return {"plain": _plain, "pad64": _padded(64), "pad16": _padded(16),
            "two_stage": _two_stage, "committed": common._mean_square}


def check_rows(torch, dev, fns) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, d in WIDTHS.items():
        x = torch.randn(max(ROWS), d, generator=g, device=dev).to(
            torch.bfloat16).float() * 3.0
        for name, fn in fns.items():
            ref8, ref16 = fn(x[:8].clone()), fn(x[:16].clone())[:8]
            got = {m: fn(x[:m].clone())[:8] for m in ROWS}
            diff = {m: int((y != ref8[:m]).sum()) for m, y in got.items()}
            diff16 = {m: int((y != ref16).sum()) for m, y in got.items()
                      if m >= 16}
            out[f"{label} {d}/{name}"] = {"vs_8": diff, "vs_16": diff16}
            bad = {m: n for m, n in diff.items() if n}
            bad16 = {m: n for m, n in diff16.items() if n}
            print(f"[rows] width {d} ({label}), {name}: rows differing "
                  f"from M 8: {bad if bad else 'none'}; from M 16 (M >= "
                  f"16): {bad16 if bad16 else 'none'}", flush=True)
    return out


def time_norm(torch, dev, fns) -> dict:
    from repro_torch.models import common
    x = torch.randn(8, 1, 2048, device=dev).to(torch.bfloat16)
    w = torch.zeros(2048, device=dev, dtype=torch.bfloat16)
    out = {}
    for name, fn in fns.items():
        common._mean_square = fn
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            for _ in range(3):
                y = x
                for _ in range(49):
                    y = common.rms_norm(y, w, 1e-5)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = x
            for _ in range(49):
                y = common.rms_norm(y, w, 1e-5)
        times = []
        for _ in range(50):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = float(np.median(times))
        print(f"[norm] {name}: 49 rms_norm calls on (8, 1, 2048) bf16 in "
              f"one graph: {out[name]:.4f} ms a replay", flush=True)
        del graph
    return out


def serve(torch, dev, model, params, prompts, max_new, slots, kv):
    from repro_torch.rl.rollout import run_requests
    from repro_torch.serve import Engine, EngineConfig, Request
    eng = Engine(model, params, EngineConfig(
        num_slots=slots, max_seq_len=MAX_SEQ, kv_layout=kv), device=dev)
    eng.warm_up()
    outs = run_requests(eng, (Request(rid=i, prompt=p,
                                      max_new_tokens=max_new)
                              for i, p in enumerate(prompts)))
    torch.cuda.synchronize()
    m = eng.metrics()
    del eng
    return outs, m.decode_time_s / max(m.steps, 1) * 1e3


def time_steps(torch, dev, models, fns) -> dict:
    from repro_torch.models import common
    out = {}
    order = list(fns) + list(fns)[::-1]
    for arch, (model, params) in models.items():
        prompts = chip_smoke.serve_prompts(model.cfg.vocab_size)[:STEP_REQ]
        for kv in ("contiguous", "paged"):
            for name in order:
                common._mean_square = fns[name]
                _, ms = serve(torch, dev, model, params, prompts, STEP_NEW,
                              SLOTS, kv)
                out.setdefault(f"{arch} {kv}", {}).setdefault(
                    name, []).append(ms)
            print(f"[step] {arch} {kv}, {SLOTS} slots, {STEP_REQ} requests "
                  f"x {STEP_NEW} new tokens, ms per decode step (in order, "
                  f"in reverse): " + "; ".join(
                      f"{n} {v[0]:.3f}, {v[1]:.3f}"
                      for n, v in out[f"{arch} {kv}"].items()), flush=True)
    return out


def check_slots(torch, dev, model, params, fns) -> dict:
    from repro_torch.models import common
    prompts = chip_smoke.serve_prompts(model.cfg.vocab_size)
    out = {}
    for name, fn in fns.items():
        common._mean_square = fn
        ref, _ = serve(torch, dev, model, params, prompts, MAX_NEW, SLOTS,
                       "paged")
        out[name] = {}
        for slots in (2, 4):
            got, _ = serve(torch, dev, model, params, prompts, MAX_NEW,
                           slots, "paged")
            out[name][slots] = [o.rid for o, r in zip(got, ref)
                                if o.tokens != r.tokens]
        print(f"[slots] {name}: {ARCH} paged bf16, rids whose tokens "
              f"differ from {SLOTS} slots: " + ", ".join(
                  f"{s} slots {v}" for s, v in out[name].items()),
              flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("norm_rows: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.models import common
    dev = torch.device("cuda", 0)
    _build.build_all()
    committed = common._mean_square
    fns = variants()
    res = {"card": chip_smoke.card_line(), "torch": torch.__version__}
    print(f"{res['card']}; torch {torch.__version__}", flush=True)
    try:
        res["rows"] = check_rows(torch, dev, fns)
        res["norm_ms"] = time_norm(torch, dev, fns)
        models = {a: chip_smoke.build(torch, dev, a) for a in
                  (ARCH, ZAMBA_ARCH)}
        res["step_ms"] = time_steps(torch, dev, models, fns)
        del models[ZAMBA_ARCH]
        res["slots"] = check_slots(torch, dev, *models[ARCH], fns)
    finally:
        common._mean_square = committed
    out_dir = os.path.join(chip_smoke.ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "norm_rows.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(res["card"])
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"norm_rows: {time.perf_counter() - t0:.1f}s")
    sys.exit(rc)
