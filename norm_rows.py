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

5. decode rows — ``stacks_infer.DECODE_ROWS`` at 1 (the step on its live
   rows only) and at 16 (norms, products and logits on at least 16
   rows), each with the greedy kernel's cluster chosen by the row count
   (``sampling.greedy_cluster``) and with the cluster of 16 rows at every
   row count: internlm2-1.8b paged bf16, the 16 serve prompts at 128 new
   tokens through 2, 4 and 16 slots against 8: the rids whose tokens
   differ and those whose log-probabilities differ, bit for bit; and ms
   per decode step at 8 and 16 slots (contiguous and paged, 8 and 16
   requests x 64 new tokens), each variant in order and again in reverse.
   Then the cost of the committed variant (``rows16-cluster16``) against
   the step on its live rows (``rows1``) on the other served dense models
   at the smoke's slot counts (contiguous, requests x 64 new tokens, in
   order and in reverse): gemma3-4b and qwen2-vl-7b (text prompts) at 8
   slots, minitron-8b and qwen2.5-32b at 4, and whisper-tiny at 8 (zero
   frames).

    python3 norm_rows.py --decode-rows [--models-only]

runs section 5 alone (``--models-only``: its timing of the other
models).  Writes ``chiprun_out/norm_rows.json`` (with
``--decode-rows``, ``chiprun_out/decode_rows.json``).  Needs a CUDA card.
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


def decode_row_variants() -> dict:
    """(DECODE_ROWS, greedy cluster rule) by name."""
    from repro_torch.kernels import sampling
    by_rows = sampling.greedy_cluster

    def fixed(B):
        return by_rows(max(B, 16))
    return {"rows1": (1, by_rows), "rows1-cluster16": (1, fixed),
            "rows16": (16, by_rows), "rows16-cluster16": (16, fixed)}


def check_decode_rows(torch, dev, model, params) -> dict:
    from repro_torch.kernels import sampling
    from repro_torch.models import stacks_infer
    rows0, cluster0 = stacks_infer.DECODE_ROWS, sampling.greedy_cluster
    prompts = chip_smoke.serve_prompts(model.cfg.vocab_size)
    out = {"slots": {}, "step_ms": {}}
    variants = decode_row_variants()
    try:
        for name, (rows, cluster) in variants.items():
            stacks_infer.DECODE_ROWS, sampling.greedy_cluster = rows, cluster
            ref, _ = serve(torch, dev, model, params, prompts, MAX_NEW,
                           SLOTS, "paged")
            res = out["slots"][name] = {}
            for slots in (2, 4, 16):
                got, _ = serve(torch, dev, model, params, prompts, MAX_NEW,
                               slots, "paged")
                res[slots] = {
                    "tokens": [o.rid for o, r in zip(got, ref)
                               if o.tokens != r.tokens],
                    "logprobs": [o.rid for o, r in zip(got, ref)
                                 if not np.array_equal(
                                     np.asarray(o.logprobs, np.float32),
                                     np.asarray(r.logprobs, np.float32))]}
            print(f"[decode-rows] {name}: {ARCH} paged bf16, {len(prompts)} "
                  f"requests x {MAX_NEW}, rids differing from {SLOTS} "
                  f"slots: " + "; ".join(
                      f"{s} slots tokens {v['tokens']} logprobs "
                      f"{v['logprobs']}" for s, v in res.items()),
                  flush=True)
        order = list(variants) + list(variants)[::-1]
        for kv in ("contiguous", "paged"):
            for slots in (SLOTS, 16):
                key = f"{kv} {slots} slots"
                for name in order:
                    rows, cluster = variants[name]
                    stacks_infer.DECODE_ROWS = rows
                    sampling.greedy_cluster = cluster
                    _, ms = serve(torch, dev, model, params,
                                  prompts[:slots], STEP_NEW, slots, kv)
                    out["step_ms"].setdefault(key, {}).setdefault(
                        name, []).append(ms)
                print(f"[decode-rows] {ARCH} {key}, {slots} requests x "
                      f"{STEP_NEW} new tokens, ms per decode step (in "
                      f"order, in reverse): " + "; ".join(
                          f"{n} {v[0]:.4f}, {v[1]:.4f}"
                          for n, v in out["step_ms"][key].items()),
                      flush=True)
    finally:
        stacks_infer.DECODE_ROWS, sampling.greedy_cluster = rows0, cluster0
    return out


COST_MODELS = (("gemma3-4b", 8), ("qwen2-vl-7b", 8), ("whisper-tiny", 8),
               ("minitron-8b", 4), ("qwen2.5-32b", 4))


def time_decode_rows_models(torch, dev) -> dict:
    """ms per decode step of ``rows1`` and ``rows16-cluster16`` on each of
    COST_MODELS, one model on the card at a time."""
    import gc

    from repro_torch.kernels import sampling
    from repro_torch.models import stacks_infer
    from repro_torch.rl.rollout import run_requests
    from repro_torch.serve import Engine, EngineConfig, Request
    variants = {k: v for k, v in decode_row_variants().items()
                if k in ("rows1", "rows16-cluster16")}
    rows0, cluster0 = stacks_infer.DECODE_ROWS, sampling.greedy_cluster
    out = {}
    try:
        for arch, slots in COST_MODELS:
            model, params = chip_smoke.build(torch, dev, arch)
            cfg = model.cfg
            prompts = chip_smoke.serve_prompts(cfg.vocab_size)[:slots]
            frames = (np.zeros((1, cfg.max_source_len, cfg.d_model),
                               np.float32) if cfg.frontend == "audio"
                      else None)
            res = out[f"{arch} {slots} slots"] = {}
            for name in list(variants) + list(variants)[::-1]:
                stacks_infer.DECODE_ROWS, sampling.greedy_cluster = \
                    variants[name]
                eng = Engine(model, params, EngineConfig(
                    num_slots=slots, max_seq_len=MAX_SEQ), device=dev)
                eng.warm_up()
                run_requests(eng, (Request(rid=i, prompt=p,
                                           max_new_tokens=STEP_NEW,
                                           frontend=frames)
                                   for i, p in enumerate(prompts)))
                torch.cuda.synchronize()
                m = eng.metrics()
                res.setdefault(name, []).append(
                    m.decode_time_s / max(m.steps, 1) * 1e3)
                del eng
            print(f"[decode-rows] {arch} contiguous, {slots} slots, {slots} "
                  f"requests x {STEP_NEW} new tokens, ms per decode step "
                  f"(in order, in reverse): " + "; ".join(
                      f"{n} {v[0]:.4f}, {v[1]:.4f}" for n, v in res.items()),
                  flush=True)
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        stacks_infer.DECODE_ROWS, sampling.greedy_cluster = rows0, cluster0
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
    if "--decode-rows" in sys.argv[1:]:
        res = {"card": chip_smoke.card_line(), "torch": torch.__version__}
        print(f"{res['card']}; torch {torch.__version__}", flush=True)
        if "--models-only" not in sys.argv[1:]:
            res["decode_rows"] = check_decode_rows(
                torch, dev, *chip_smoke.build(torch, dev, ARCH))
        res["decode_rows_models"] = time_decode_rows_models(torch, dev)
        out_dir = os.path.join(chip_smoke.ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "decode_rows.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(res["card"])
        return 0
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
