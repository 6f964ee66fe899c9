#!/usr/bin/env python3
"""Where a served model's decode and prefill time goes on one H100.

    python3 profile_step.py [--arch zamba2-2.7b|internlm2-1.8b|rwkv6-7b|
                             gemma3-4b]

Builds the CUDA kernels, initialises the model at full width in bf16 with
seeded random weights (as ``chip_smoke.py`` does), and runs
``torch.profiler`` over a batched decode step of a full pool (8 slots at
position 300):

* zamba2-2.7b (the default): the plain decode step, and one prefill at
  S 512 with the device time and share of the SSD scan (54 calls, every
  kernel of ``csrc/mamba2_scan.cu`` matched by name) and of flash
  attention (9 launches);
* rwkv6-7b: the plain decode step, and one prefill at S 512 with the
  device time and share of the WKV scan (32 calls, every kernel of
  ``csrc/rwkv6_scan.cu`` matched by name: ``wkv_states``, ``_pass`` and
  ``_output``, or the one ``rwkv6_scan_kernel`` of the one-chunk-at-a-time
  design before them);
* internlm2-1.8b: the contiguous decode step through the decode attention
  kernel (the index reset to 300 before each call, one fill), with decode
  attention's share of the step's device time; one prefill at S 512, with
  flash attention's device time (24 launches) and its share of the
  prefill's device time; then the device time of
  decode attention's two passes (split and merge) at ``chip_smoke.py``'s
  main and long shapes and with every row full, the L2 flushed before
  each call as ``chip_smoke.py``'s timer does, and the split pass's rate
  (live K/V bytes over its device time);
* gemma3-4b: as internlm2, with the pool at position 1500 of 2048 (past
  its 1024 window: 29 of 34 layers windowed) and the prefill at S 1900
  (34 flash launches), decode attention's and flash's shares at D 256.

Then, for every KV layout the architecture serves (internlm2 and gemma3:
contiguous, paged, paged-int8; rwkv6 and zamba2: contiguous), one engine
tick of 8 live slots from position 300 (gemma3: 1500) (``Engine.step``:
the decode block, its copy to the host and the scheduler's bookkeeping),
once with the decode block run eagerly and once as the CUDA graph replay
the engine captures, on engines of the same shape.

For each it prints the wall time of a call, the device events per call,
the device-busy time (the sum of their times), the idle share of the wall
time, and the aten ops and device kernels with the most device time.
Nothing is held to these numbers; they feed PERF.md's breakdown.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import chip_smoke
from chip_smoke import (ARCH, ATTN_CASES, GEMMA_ARCH, GEMMA_SEQ, MAX_SEQ,
                        RWKV_ARCH, SLOTS, ZAMBA_ARCH)

# device kernels by name: csrc/decode_attention.cu's, every forward kernel
# of csrc/flash_attention.cu (flash_fwd_*), every kernel of
# csrc/mamba2_scan.cu (mamba2_ssd_states, _pass and _output; the one
# mamba2_scan_kernel before them) and of csrc/rwkv6_scan.cu (wkv_states,
# _pass and _output; the one rwkv6_scan_kernel before them)
DECODE_ATTN = {"decode attention": ("decode_split_kernel",
                                    "decode_merge_kernel")}
FLASH = {"flash attention": ("flash_fwd",)}
SSD_AND_FLASH = {"SSD scan": ("mamba2_",), **FLASH}
WKV = {"WKV scan": ("wkv_", "rwkv6_scan_kernel")}


def _dev_us(e):
    """An event's own device time in us (self_cuda_time_total before torch
    2.4)."""
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def profile_calls(torch, fn, n: int = 3, match=DECODE_ATTN) -> dict:
    """Wall time of one call (host clock around ``n`` calls that end in a
    synchronize), then ``n`` calls under ``torch.profiler``: device events
    (kernels and copies) per call, device-busy ms per call (the sum of
    their times), for each ``{label: names}`` of ``match`` the device ms
    and the launches per call of the kernels whose names contain one of
    ``names``, the idle share of the wall time, and the aten ops and the
    device kernels with the most device time."""
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

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    if not events:      # the profiler saw no device activity
        return {"wall_ms": wall, "device_events": None,
                "device_busy_ms": None, "idle_share": None, "top_ops": [],
                "top_kernels": [], "matched": None}
    busy = sum(_dev_us(e) for e in events) / n / 1e3
    matched = {}
    for label, names in match.items():
        hit = [e for e in events if any(k in e.name for k in names)]
        matched[label] = {"ms": sum(_dev_us(e) for e in hit) / n / 1e3,
                          "launches": len(hit) / n}
    ops = sorted(((k.key, _dev_us(k) / n / 1e3, k.count // n)
                  for k in prof.key_averages() if k.key.startswith("aten::")
                  and _dev_us(k) > 0), key=lambda t: -t[1])[:6]
    by_name: dict = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + _dev_us(e), c + 1)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall, "device_events": len(events) / n,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "matched": matched,
            "top_ops": [{"op": o, "device_ms": t, "calls": c}
                        for o, t, c in ops],
            "top_kernels": [{"kernel": k[:60], "device_ms": t / n / 1e3,
                             "calls": c // n} for k, (t, c) in kernels]}


def profile_ticks(torch, dev, model, params, layouts=(("contiguous", None),),
                  match=None, n: int = 5, pos: int = 300,
                  max_seq: int = MAX_SEQ) -> dict:
    """One engine tick of ``SLOTS`` live slots from position ``pos``, for each
    ``(kv_layout, kv_dtype)`` of ``layouts``: through the eager decode
    block (``chip_smoke.eager_engine``) and through the CUDA graph, each
    on its own engine after two warm ticks (the first runs eagerly, the
    second is the graph's first replay)."""
    from repro_torch.serve import Engine, EngineConfig, Request

    res = {}
    for kv, kv_dtype in layouts:
        run = kv + ("-int8" if kv_dtype else "")
        for name, make in (("eager", chip_smoke.eager_engine),
                           ("graph", Engine)):
            eng = make(model, params, EngineConfig(
                num_slots=SLOTS, max_seq_len=max_seq, kv_layout=kv,
                kv_dtype=kv_dtype), device=dev)
            rs = np.random.RandomState(6)
            for i in range(SLOTS):
                eng.submit(Request(rid=i, prompt=rs.randint(
                    0, model.cfg.vocab_size, pos).astype(np.int32),
                    max_new_tokens=4 + 2 * n))
            eng.step()
            eng.step()
            key = f"tick {run} {name}"
            res[key] = profile_calls(torch, eng.step, n=n,
                                     match=match or {})
            res[key]["captures"] = eng.captures
            del eng
    report(res)
    return res


def profile_recurrent(torch, dev, model, params, match) -> dict:
    """Where a decode step and a prefill of a recurrent model (zamba2,
    rwkv6) spend their time: the batched decode step of a full pool (8
    slots at position 300) and one prefill at S 512, with the device time
    of the kernels ``match`` names."""
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
                   1, MAX_SEQ, device=dev)), match=match)}
    report(res)
    report_share(res, "prefill_512")
    del pool
    res.update(profile_ticks(torch, dev, model, params))
    return res


def profile_zamba2(torch, dev, model, params) -> dict:
    """zamba2's decode step and S 512 prefill, with the SSD scan's and
    flash attention's device time in the prefill."""
    return profile_recurrent(torch, dev, model, params, SSD_AND_FLASH)


def profile_rwkv6(torch, dev, model, params) -> dict:
    """rwkv6's decode step and S 512 prefill, with the WKV scan's device
    time in the prefill."""
    return profile_recurrent(torch, dev, model, params, WKV)


def profile_internlm2(torch, dev, model, params, pos: int = 300,
                      prefill: int = 512, max_seq: int = MAX_SEQ) -> dict:
    """Where internlm2 spends its time: the kernel decode step of a full
    pool (8 slots at position ``pos``), with decode attention's share of
    the device time; one prefill of ``prefill`` ids, with flash
    attention's share."""
    pool = model.init_cache(SLOTS, max_seq, device=dev)
    pool["index"] = torch.full((SLOTS,), pos, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    tok = torch.randint(0, model.cfg.vocab_size, (SLOTS, 1), device=dev,
                        generator=g)

    def step():
        pool["index"].fill_(pos)
        return model.kernel_decode_step(params, tok, pool)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prefill), device=dev,
                           generator=g)
    name = f"prefill_{prefill}"
    res = {"decode_step": profile_calls(torch, step),
           name: profile_calls(
               torch, lambda: model.prefill(params, prompt, model.init_cache(
                   1, max_seq, device=dev)), match=FLASH)}
    report(res)
    report_share(res, "decode_step")
    report_share(res, name)
    del pool
    if model.cfg.name == ARCH:
        res["decode_attention_passes"] = profile_decode_passes(torch, dev)
    ticks = profile_ticks(
        torch, dev, model, params,
        (("contiguous", None), ("paged", None), ("paged", "int8")),
        match={"decode attention": DECODE_ATTN["decode attention"]},
        pos=pos, max_seq=max_seq)
    for name in ticks:
        report_share(ticks, name)
    res.update(ticks)
    return res


def profile_decode_passes(torch, dev, n: int = 20) -> dict:
    """Device time of decode attention's split pass and merge pass at
    chip_smoke's ATTN_CASES and with every row full (8 rows of 1024 and of
    4096), H 16, Hkv 8, D 128, bf16; a 256 MB write flushes the L2 before
    each call, as chip_smoke's Timer does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention as da

    H, Hkv, D = 16, 8, 128
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    cases = list(ATTN_CASES) + [(f"full{S}", np.full(8, S, np.int32), S)
                                for S in (1024, 4096)]
    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for label, lengths_np, S in cases:
        B = len(lengths_np)
        q, k, v = (torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16) for shape in ((B, H, D), (B, S, Hkv, D),
                                          (B, S, Hkv, D)))
        lengths = torch.from_numpy(lengths_np).to(dev)
        da.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                da.decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
        t = {p: sum(_dev_us(e) for e in prof.events()
                    if e.device_type == cuda and f"decode_{p}_kernel" in e.name)
             / n / 1e3 for p in ("split", "merge")}
        kv_bytes = int(np.minimum(lengths_np, S).sum()) * Hkv * D * 2 * 2
        if not t["split"]:      # the profiler saw no device activity
            print(f"[profile] decode attention {label}: device time not "
                  f"measured (no device events)")
            continue
        rate = kv_bytes / (t["split"] * 1e-3) / 1e12
        print(f"[profile] decode attention {label} (S={S}, {kv_bytes / 1e6:.1f}"
              f" MB of live K/V): split pass {t['split']:.4f} ms "
              f"({rate:.2f} TB/s), merge {t['merge']:.4f} ms")
        res[label] = dict(split_ms=t["split"], merge_ms=t["merge"],
                          kv_bytes=kv_bytes, split_tb_per_s=rate)
        del q, k, v
    return res


def report(res: dict) -> None:
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


def report_share(res: dict, name: str) -> None:
    """Each matched group's device time in ``res[name]``, its kernel
    launches and its share of the device-busy time."""
    r = res[name]
    if r["device_events"] is None:
        return
    for what, m in r["matched"].items():
        print(f"[profile] {name}: {what} {m['ms']:.3f} ms of device time "
              f"in {m['launches']:.0f} kernel launches, share "
              f"{m['ms'] / r['device_busy_ms']:.3f}")


def profile_gemma3(torch, dev, model, params) -> dict:
    """gemma3-4b as internlm2, past its window: the pool at position 1500
    of GEMMA_SEQ, the prefill at S 1900."""
    return profile_internlm2(torch, dev, model, params, pos=1500,
                             prefill=1900, max_seq=GEMMA_SEQ)


PROFILES = {ZAMBA_ARCH: profile_zamba2, ARCH: profile_internlm2,
            RWKV_ARCH: profile_rwkv6, GEMMA_ARCH: profile_gemma3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=tuple(PROFILES), default=ZAMBA_ARCH)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    model, params = chip_smoke.build(torch, dev, args.arch)
    PROFILES[args.arch](torch, dev, model, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
