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
3. flash   — the flash-attention kernel against its plain version at the
             training shape (16 rows, S 143, H 16, Hkv 8, D 128, bf16) and
             at S 4096 (2 rows); the gradients of ``FlashAttentionFn``
             against autograd through the plain version; times of the
             kernel, the plain version, ``scaled_dot_product_attention``
             and the bound.
4. serve   — internlm2-1.8b at full width (24 layers, d_model 2048, vocab
             92544) in bf16 with seeded random weights: 16 requests with
             prompts of 32-512 token ids, 8 slots, 128 new tokens, through
             ``serve_continuous`` for contiguous, paged and paged-int8 KV.
             Kernel launch counts are zeroed before and read after each
             run; every decode kernel must have run layers x decode steps
             times, greedy sampling once per decode step, flash attention
             once per layer and prefill.
5. train   — two GRPO iterations at full width through ``run_training``
             (batch 4 x group 4, 128 new tokens, temperature 1, engine
             rollout, ``--mux off``): decode attention layers x decode
             steps times, flash attention layers x (prefills + 2) times per
             iteration (the forward and its recompute under remat), greedy
             sampling never; finite loss and gradient norm; the trainer's
             log-probabilities of the sampled tokens match the engine's
             (mean ratio within 1e-2 of 1); the weights move.

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


# (label, rows, positions): the training shape, and a long one
FLASH_CASES = (("main", 16, 16 + MAX_NEW - 1), ("long", 2, 4096))


def phase_flash(torch, dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    H, Hkv, D = 16, 8, 128
    row = {"max_abs_err": 0.0}
    for label, B, S in FLASH_CASES:
        g = torch.Generator(device=dev).manual_seed(2)
        q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev,
                               dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
        err = check_close(torch, f"flash_attention {label}",
                          fa.flash_attention(q, k, v),
                          fa.flash_attention_plain(q, k, v), ATTN_TOL)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        # gradients: FlashAttentionFn against autograd through the plain
        dout = torch.randn(B, S, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16)
        got = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.FlashAttentionFn.apply(*got, True, None).backward(dout)
        ref = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.flash_attention_plain(*ref).backward(dout)
        g_err = {n: check_close(torch, f"flash_attention {label} {n}",
                                a.grad, b.grad, ATTN_TOL)
                 for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        del got, ref
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        kt, vt, qt = k.transpose(1, 2), v.transpose(1, 2), q.transpose(1, 2)
        ms = timer(lambda: fa.flash_attention(q, k, v, return_lse=True))
        plain_ms = timer(lambda: fa.flash_attention_plain(q, k, v,
                                                          return_lse=True),
                         iters=10)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bwd_ms = timer(lambda: fa.flash_attention_backward_plain(
            q, k, v, out, lse, dout), iters=10)
        n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 \
            + lse.numel() * 4
        n_ops = 4 * B * H * D * (S * (S + 1) // 2)     # causal pairs only
        b_ms, b_by = bound(n_bytes, n_ops, "bfloat16")
        print(f"[flash] {label} (B={B}, S={S}): max_abs_err={err:.3e} "
              f"grad max_abs_err {g_err} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}); plain backward {bwd_ms:.4f} "
              f"ms")
        row[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          backward_plain_ms=bwd_ms, grad_err=g_err)
        if label == "main":
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, lse, dout
    return row


def wrappers():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sampling
    return {"decode_attention": da.decode_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "greedy_sample": sampling.greedy_sample,
            "flash_attention": fa.flash_attention}


def build(torch, dev):
    from repro_torch.models import build_model

    model = build_model(ARCH)
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] {ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab_size}, {n_params / 1e9:.3f}B params "
          f"({cfg.dtype}) initialised in {time.perf_counter() - t0:.1f}s")
    return model, params


def phase_serve(torch, dev, model, params):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import serve_continuous

    cfg = model.cfg
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
        want["flash_attention"] = cfg.num_layers * rep["prefills"]
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


def token_share_reward(vocab_size: int):
    """Row-wise verifier for the train phase: the share of a row's
    recorded tokens in the lower half of the vocabulary.  A randomly
    initialised full-vocabulary model earns 0 from the arithmetic verifier
    on every row (its samples are almost never byte tokens), which makes
    every GRPO advantage, and so every gradient, exactly 0; this reward
    differs from row to row, so the step has something to learn."""
    def reward(completions, mask, answers):
        comp, m = np.asarray(completions), np.asarray(mask)
        low = ((comp < vocab_size // 2) * m).sum(1)
        return (low / np.maximum(m.sum(1), 1)).astype(np.float32)
    return reward


def phase_train(torch, dev, model, params):
    from repro_torch.launch.train import run_training

    cfg = model.cfg
    watch = {"embed": params["embed"], "lm_head": params["lm_head"],
             "layer0.wq": params["layers"][0]["attn"]["wq"],
             "layer23.mlp.wo": params["layers"][-1]["mlp"]["wo"]}
    before = {n: t.clone() for n, t in watch.items()}
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist, report = run_training(
        ARCH, model=model, params=params, steps=2, batch=4, group=4,
        max_new=MAX_NEW, temperature=1.0,
        reward_fn=token_share_reward(cfg.vocab_size),
        device=dev, log_every=1, return_report=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    steps = sum(r["decode_steps"] for r in hist)
    prefills = sum(r["prefills"] for r in hist)
    want = {"decode_attention": cfg.num_layers * steps,
            "paged_decode_attention": 0, "greedy_sample": 0,
            "flash_attention": cfg.num_layers * (prefills + 2 * len(hist))}
    if len(hist) != 2 or prefills != 2 * 16 or counts != want:
        raise AssertionError(f"train: launches {counts} != {want} "
                             f"({len(hist)} iterations, {prefills} "
                             f"prefills)")
    for r in hist:
        if not all(np.isfinite(r[k]) for k in ("loss", "grad_norm",
                                                "entropy", "reward")) \
                or r["grad_norm"] <= 0 or r["tokens"] < 1:
            raise AssertionError(f"train: iteration {r['step']} malformed: "
                                 f"{r}")
        # the trainer's forward (flash attention) and the engine's decode
        # (decode attention) score the sampled tokens alike: the masked
        # mean of exp(logp - behaviour logp) is 1 up to bf16 rounding
        if abs(r["ratio_mean"] - 1) > 1e-2:
            raise AssertionError(f"train: iteration {r['step']}: policy and "
                                 f"behaviour logprobs disagree, ratio_mean "
                                 f"{r['ratio_mean']}")
    moved = {n: not torch.equal(before[n], t) for n, t in watch.items()}
    if not all(moved.values()):
        raise AssertionError(f"train: weights did not move: {moved}")
    if not all(torch.isfinite(t).all() for t in watch.values()):
        raise AssertionError("train: non-finite weights after the step")
    s = report.summary()
    roll = [t1 - t0_ for _, t0_, t1 in report.timelines["rollout"]]
    train = [t1 - t0_ for _, t0_, t1 in report.timelines["train"]]
    positions = 4 * 4 * (16 + MAX_NEW - 1)      # rows x trained positions
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {ARCH}: 2 GRPO iterations in {wall:.2f}s; rollout "
          f"busy {s['total_rollout_s']:.2f}s {roll}, train busy "
          f"{s['total_train_s']:.2f}s {train}; {positions} positions per "
          f"step, {positions * len(train) / s['total_train_s']:.1f} "
          f"training tokens/s; peak memory {peak / 2 ** 30:.2f} GiB; "
          f"launches {counts}")
    for r in hist:
        print(f"[train] iteration {r['step']}: loss={r['loss']:.6f} "
              f"grad_norm={r['grad_norm']:.4f} entropy={r['entropy']:.4f} "
              f"reward={r['reward']:.4f} ratio_mean={r['ratio_mean']:.6f} "
              f"ratio_max={r['ratio_max']:.4f} tokens={r['tokens']} "
              f"decode_steps={r['decode_steps']}")
    del state
    return counts, {"wall_s": wall, "rollout_s": roll, "train_s": train,
                    "positions_per_step": positions,
                    "train_tokens_per_s": positions * len(train)
                    / s["total_train_s"],
                    "max_memory_allocated": peak, "history": hist,
                    "launches": counts}


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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:24"),
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
    rows["flash_attention"] = phase_flash(torch, dev, timer)
    del timer
    torch.cuda.empty_cache()
    model, params = build(torch, dev)
    launches, serve = phase_serve(torch, dev, model, params)
    train_launches, train = phase_train(torch, dev, model, params)
    for k, n in train_launches.items():
        launches[k] += n
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
        json.dump({"card": smi, "kernels": kernels, "serve": serve,
                   "flash": rows["flash_attention"], "train": train}, f,
                  indent=1, default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
