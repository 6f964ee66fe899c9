#!/usr/bin/env python3
"""Where zamba2-2.7b's serving time goes on one H100.

    python3 profile_zamba2.py

Builds the CUDA kernels, initialises zamba2-2.7b at full width in bf16 with
seeded random weights (as ``chip_smoke.py`` does), and runs
``torch.profiler`` over a batched decode step of a full pool (8 slots at
position 300) and over one prefill at S 512.  For each it prints the wall
time of a call, the device events per call, the device-busy time (the sum
of their times), the idle share of the wall time, and the aten ops and
device kernels with the most device time.  Nothing is held to these
numbers; they feed PERF.md's breakdown.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time

import chip_smoke
from chip_smoke import MAX_SEQ, SLOTS, ZAMBA_ARCH


def profile_calls(torch, fn, n: int = 3) -> dict:
    """Wall time of one call (host clock around ``n`` calls that end in a
    synchronize), then ``n`` calls under ``torch.profiler``: device events
    (kernels and copies) per call, device-busy ms per call (the sum of
    their times), the idle share of the wall time, and the aten ops and
    the device kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):      # self_cuda_time_total before torch 2.4
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    if not events:      # the profiler saw no device activity
        return {"wall_ms": wall, "device_events": None,
                "device_busy_ms": None, "idle_share": None, "top_ops": [],
                "top_kernels": []}
    busy = sum(dev_us(e) for e in events) / n / 1e3
    ops = sorted(((k.key, dev_us(k) / n / 1e3, k.count // n)
                  for k in prof.key_averages() if k.key.startswith("aten::")
                  and dev_us(k) > 0), key=lambda t: -t[1])[:6]
    by_name: dict = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + dev_us(e), c + 1)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall, "device_events": len(events) / n,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "top_ops": [{"op": o, "device_ms": t, "calls": c}
                        for o, t, c in ops],
            "top_kernels": [{"kernel": k[:60], "device_ms": t / n / 1e3,
                             "calls": c // n} for k, (t, c) in kernels]}


def profile_zamba2(torch, dev, model, params) -> dict:
    """Where a decode step and a prefill of zamba2 spend their time: the
    batched decode step of a full pool (8 slots at position 300) and one
    prefill at S 512."""
    cfg = model.cfg
    pool = model.init_cache(SLOTS, MAX_SEQ, device=dev)
    pool["index"] = torch.full((SLOTS,), 300, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (SLOTS, 1), device=dev,
                        generator=g)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), device=dev,
                           generator=g)
    res = {"decode_step": profile_calls(
               torch, lambda: model.decode_step(params, tok, pool)),
           "prefill_512": profile_calls(
               torch, lambda: model.prefill(params, prompt, model.init_cache(
                   1, MAX_SEQ, device=dev)))}
    for name, r in res.items():
        if r["device_events"] is None:
            print(f"[profile] {name}: wall {r['wall_ms']:.2f} "
                  f"ms; device time not measured (no device events)")
            continue
        top = ", ".join(f"{t['op']} {t['device_ms']:.3f} ms x{t['calls']}"
                        for t in r["top_ops"])
        kern = ", ".join(f"{t['kernel']} {t['device_ms']:.3f} ms "
                         f"x{t['calls']}" for t in r["top_kernels"])
        print(f"[profile] {name}: wall {r['wall_ms']:.2f} ms, "
              f"{r['device_events']:.0f} device events, device busy "
              f"{r['device_busy_ms']:.2f} ms (idle share "
              f"{r['idle_share']:.3f}); most device time by op: {top}; by "
              f"kernel: {kern}")
    del pool
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_zamba2: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    model, params = chip_smoke.build(torch, dev, ZAMBA_ARCH)
    profile_zamba2(torch, dev, model, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
