#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build   — compile every CUDA source of ``repro_torch/kernels/csrc`` with
             nvcc for sm_90a (one nvcc per source, started together).
2. kernels — at the serving path's shapes (internlm2-1.8b: H=16, Hkv=8,
             D=128, bf16, 8 rows, ragged lengths up to 1024, bs=16) and one
             long row set up to 4096, hold each kernel against its plain
             PyTorch version and time kernel, plain version, one PyTorch
             library call, and the bound (bytes / 3.35 TB/s or operations /
             peak rate, the larger).
3. serve   — internlm2-1.8b at full width (24 layers, d_model 2048, vocab
             92544) in bf16 with seeded random weights: 16 requests with
             prompts of 32-512 token ids, 8 slots, 128 new tokens, through
             ``serve_continuous`` for contiguous, paged and paged-int8 KV.
             Kernel launch counts are zeroed before and read after each
             run; every decode kernel must have run layers x decode steps
             times, greedy sampling once per decode step.

Prints the card's name and power limit, a JSON line with every kernel's
numbers, and as its last line ``{"ok": true, "device": {...}}``.  Needs a
CUDA card; there is no CPU path.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BPS = 3.35e12          # H100 SXM device memory rate, bytes/s
PEAK = {"bfloat16": 989e12, "float32": 67e12}   # dense ops/s by input type
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)
ARCH, SLOTS, MAX_NEW, MAX_SEQ, N_REQ = "internlm2-1.8b", 8, 128, 1024, 16


def bound(n_bytes: float, n_ops: float, dtype: str):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device=dev)          # 256 MB > 50 MB L2

    def __call__(self, fn, iters: int = 30) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))


# (label, ragged lengths, stripe length S): the serving shape, a long set
ATTN_CASES = (
    ("main", np.asarray([1, 17, 100, 255, 512, 640, 900, 1024], np.int32),
     1024),
    ("long", np.asarray([4096, 3000, 2048, 1500, 1024, 777, 300, 64],
                        np.int32), 4096))


def check_close(torch, name, got, ref, tol) -> float:
    err = float((got.float() - ref.float()).abs().max())
    if not torch.allclose(got.float(), ref.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def phase_kernels(torch, dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import sampling
    from repro_torch.models.kvcache import quantize_kv

    rs = np.random.RandomState(0)
    H, Hkv, D, bs = 16, 8, 128, 16
    bf = dict(dtype=torch.bfloat16, device=dev)
    rows = {}

    def sdpa(q, k, v, lengths):
        """F.scaled_dot_product_attention on a (B, S, Hkv, D) view."""
        S = k.shape[1]
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)

    def record(key, label, err, ms, plain_ms, lib_ms, n_bytes, n_ops,
               dtype="bfloat16"):
        b_ms, b_by = bound(n_bytes, n_ops, dtype)
        print(f"[kernels] {key} {label}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        r = rows.setdefault(key, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if label == "main":
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by)

    for label, lengths_np, S in ATTN_CASES:
        B = len(lengths_np)
        lengths = torch.from_numpy(lengths_np).to(dev)
        live = int(np.minimum(lengths_np, S).sum())
        q = torch.randn(B, H, D, **bf)
        qo_bytes = 2 * B * H * D * 2 + B * 4
        ops = 4 * H * D * live
        # contiguous
        k = torch.randn(B, S, Hkv, D, **bf)
        v = torch.randn(B, S, Hkv, D, **bf)
        out = da.decode_attention(q, k, v, lengths)
        err = check_close(torch, "decode_attention", out,
                          da.decode_attention_plain(q, k, v, lengths),
                          ATTN_TOL)
        record("decode_attention", label, err,
               timer(lambda: da.decode_attention(q, k, v, lengths)),
               timer(lambda: da.decode_attention_plain(q, k, v, lengths)),
               timer(sdpa(q, k, v, lengths)),
               live * Hkv * D * 2 * 2 + qo_bytes, ops)
        del k, v
        # paged: shuffled tables, null-block tails
        MB = S // bs
        NB = B * MB + 1
        ids = rs.permutation(np.arange(1, NB))
        tables_np = np.zeros((B, MB), np.int32)
        nxt = 0
        for b, n in enumerate(lengths_np):
            nb = -(-int(n) // bs)
            tables_np[b, :nb] = ids[nxt:nxt + nb]
            nxt += nb
        tables = torch.from_numpy(tables_np).to(dev)
        kp = torch.randn(NB, bs, Hkv, D, **bf)
        vp = torch.randn(NB, bs, Hkv, D, **bf)
        kq, ks = quantize_kv(kp, 2)
        vq, vs = quantize_kv(vp, 2)
        tbl_bytes = int((tables_np > 0).sum()) * 4
        for mode, args, kw, elem, extra in (
                ("bf16", (kp, vp), {}, 2, 0),
                ("int8", (kq, vq), dict(k_scale=ks, v_scale=vs), 1,
                 live * 4 * 2)):
            def kern():
                return da.paged_decode_attention(q, *args, tables, lengths,
                                                 **kw)

            def plain():
                return da.paged_decode_attention_plain(
                    q, *args, tables, lengths, **kw)
            err = check_close(torch, f"paged_decode_attention[{mode}]",
                              kern(), plain(), ATTN_TOL)
            kg = da.gather_view(args[0], tables, kw.get("k_scale"))
            vg = da.gather_view(args[1], tables, kw.get("v_scale"))
            record("paged_decode_attention", f"{label}" if mode == "bf16"
                   else f"{label}-int8", err, timer(kern), timer(plain),
                   timer(sdpa(q, kg.to(torch.bfloat16),
                              vg.to(torch.bfloat16), lengths)),
                   live * Hkv * D * 2 * elem + extra + qo_bytes + tbl_bytes,
                   ops)
            del kg, vg
        del kp, vp, kq, vq, ks, vs

    # greedy sampling at the vocabulary of internlm2, planted ties
    B, V = 8, 92544
    x = torch.randn(B, V, dtype=torch.float32, device=dev)
    x[0, [100, 5000]] = 50.0          # tie across 1024-wide blocks 0 and 4
    x[1, [1023, 1024]] = 40.0         # tie across a block edge
    x[2, [V - 1, 7]] = 30.0           # last column against an early one
    t_k, lp_k = sampling.greedy_sample(x)
    t_p, lp_p = sampling.greedy_sample_plain(x)
    if not torch.equal(t_k, t_p) or t_k[:3].tolist() != [100, 1023, 7]:
        raise AssertionError(f"greedy_sample tokens {t_k.tolist()} != "
                             f"plain {t_p.tolist()}")
    err = check_close(torch, "greedy_sample", lp_k, lp_p,
                      dict(atol=1e-4, rtol=0))
    record("greedy_sample", "main", err,
           timer(lambda: sampling.greedy_sample(x)),
           timer(lambda: sampling.greedy_sample_plain(x)),
           timer(lambda: (torch.argmax(x, -1), torch.logsumexp(x, -1))),
           B * V * 4 + B * 8, 3 * B * V, "float32")
    return rows


def wrappers():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import sampling
    return {"decode_attention": da.decode_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "greedy_sample": sampling.greedy_sample}


def phase_serve(torch, dev):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import build_model

    model = build_model(ARCH)
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab_size}, {n_params / 1e9:.3f}B params "
          f"({cfg.dtype}) initialised in {time.perf_counter() - t0:.1f}s")
    rs = np.random.RandomState(0)
    lens = rs.randint(32, 513, size=N_REQ)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    launches = {k: 0 for k in wrappers()}
    firsts, tokens, reports = {}, {}, {}
    for kv, kv_dtype in (("contiguous", None), ("paged", None),
                         ("paged", "int8")):
        run = kv + ("-int8" if kv_dtype else "")
        fns = wrappers()
        for f in fns.values():
            f.launches = 0
        rep = serve_continuous(ARCH, prompts, model=model, params=params,
                               max_new=MAX_NEW, num_slots=SLOTS, kv=kv,
                               kv_dtype=kv_dtype, max_seq_len=MAX_SEQ,
                               device=dev)
        counts = {k: f.launches for k, f in fns.items()}
        steps = rep["decode_steps"]
        outs = rep["outputs"]
        if len(outs) != N_REQ or any(o.finish_reason not in ("length", "eos")
                                     for o in outs):
            raise AssertionError(f"{run}: unfinished requests")
        for o in outs:
            lp = np.asarray(o.logprobs)
            if not (1 <= o.num_tokens <= MAX_NEW and np.isfinite(lp).all()
                    and (lp <= 1e-6).all()):
                raise AssertionError(f"{run}: rid {o.rid} output malformed")
        attn = "decode_attention" if kv == "contiguous" \
            else "paged_decode_attention"
        want = {k: 0 for k in counts}
        want[attn] = cfg.num_layers * steps
        want["greedy_sample"] = steps
        if counts != want:
            raise AssertionError(f"{run}: launches {counts} != {want}")
        for k in launches:
            launches[k] += counts[k]
        firsts[run] = [o.tokens[0] for o in outs]
        tokens[run] = [o.tokens for o in outs]
        step_ms = rep["decode_time_s"] / max(steps, 1) * 1e3
        print(f"[serve] {run}: {N_REQ} requests, {rep['tokens']} tokens, "
              f"{steps} decode steps in {rep['wall_s']:.2f}s = "
              f"{rep['tok_per_s']:.1f} tok/s; {step_ms:.2f} ms per decode "
              f"step, {rep['wall_s'] - rep['decode_time_s']:.2f}s outside "
              f"decode (prefill, admission); launches {counts}")
        if kv == "paged":
            recheck_pool(torch, dev, da, rep["engine"], run)
        reports[run] = {"tokens": rep["tokens"], "decode_steps": steps,
                        "wall_s": rep["wall_s"],
                        "decode_time_s": rep["decode_time_s"],
                        "tok_per_s": rep["tok_per_s"], "launches": counts}
        del rep
    if not firsts["contiguous"] == firsts["paged"] == firsts["paged-int8"]:
        raise AssertionError(f"first generated tokens differ: {firsts}")
    for run in ("paged", "paged-int8"):
        same = total = 0
        for a, b in zip(tokens["contiguous"], tokens[run]):
            n = min(len(a), len(b))
            same += sum(x == y for x, y in zip(a[:n], b[:n]))
            total += n
        print(f"[serve] {run} agrees with contiguous on {same}/{total} "
              f"tokens ({same / max(total, 1):.4f})")
        reports[run]["token_agreement_with_contiguous"] = same / max(total,
                                                                    1)
    return launches, reports


def recheck_pool(torch, dev, da, engine, run):
    """The paged kernel against its plain version on the pool and tables
    the run left (the tables of its last decode step)."""
    cache = engine.slots.cache
    tables = engine.slots._tables_dev          # last uploaded tables
    lengths = cache["index"]
    cfg = engine.model.cfg
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(SLOTS, cfg.num_heads, cfg.resolved_head_dim, generator=g,
                    device=dev, dtype=engine.params["embed"].dtype)
    for li in (0, cfg.num_layers // 2, cfg.num_layers - 1):
        kw = {}
        if "k_scale" in cache:
            kw = dict(k_scale=cache["k_scale"][li],
                      v_scale=cache["v_scale"][li])
        args = (q, cache["k"][li], cache["v"][li], tables, lengths)
        err = check_close(torch, f"{run} pool layer {li}",
                          da.paged_decode_attention(*args, **kw),
                          da.paged_decode_attention_plain(*args, **kw),
                          ATTN_TOL)
        print(f"[serve] {run}: paged kernel on the run's pool, layer {li}: "
              f"max_abs_err={err:.3e}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:44"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:138"),
    "greedy_sample": ("src/repro_torch/kernels/csrc/greedy_sample.cu",
                      "src/repro/kernels/sampling.py:34"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel libraries built for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s")
    timer = Timer(torch, dev)
    rows = phase_kernels(torch, dev, timer)
    del timer
    torch.cuda.empty_cache()
    launches, serve = phase_serve(torch, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "serve": serve}, f,
                  indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
