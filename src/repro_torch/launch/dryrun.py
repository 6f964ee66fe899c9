"""Multi-pod dry-run: place every (architecture x input shape) on the
production meshes in one process's fake world, walk its step on meta
shards, and write each rank's memory and roofline terms.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
case for 512 forced host devices.  Here the world is
``init_process_group("fake", store=FakeStore(), ...)`` of 256 ranks (one
pod, ``(16, 16)`` over ``("data", "model")``) or 512 (two pods, ``(2, 16,
16)`` over ``("pod", "data", "model")``), this process rank 0; the mesh is
a ``DeviceMesh`` on ``device_type="cpu"`` whose shards are ``meta``
tensors, so the dry-run touches no device and allocates nothing.  The
parameters (``Model.init_abstract``) and the AdamW state (``adamw_init``,
placed by ``adamw_opt_specs``) go through ``shard_params`` by the logical
specs, the inputs by the reference's logical axes; the train step
(``make_train_step``, 8 microbatches where they divide the batch,
``remat=True``), the prefill or the decode step then runs once under
``activation_sharding`` and the cost walk (``launch/cost.py``), whose
per-rank counts give the roofline terms (``launch/roofline.py``: modelled
H100 terms, not card times).  A process holds one world, so ``--all`` runs
one subprocess per case (``--jobs`` at once), resumably; it exits 1 when
any case errored or timed out.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        [--jobs 4]
    PYTHONPATH=src python -m repro_torch.launch.report single

Records go to ``results/dryrun_torch/<arch>_<shape>_<mesh>.json``: the
reference's ``status`` (``ok``, ``skipped`` with ``shape_applicable``'s
reason, ``error`` with its trace, ``timeout``), the meta fields, ``memory``
and ``roofline``, and the walk's own counts under ``walk``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.launch.cost import walk
from repro_torch.launch.roofline import analyze, memory_report, \
    model_flops_for
from repro_torch.models.model import Model
from repro_torch.models.sharding import (RULE_PROFILES, ShardingRules,
                                         activation_sharding, shard_params,
                                         spec_to_placements)
from repro_torch.rl.train_step import make_train_step
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_opt_specs, tree_leaves)

RESULTS_DIR = "results/dryrun_torch"
CASE_TIMEOUT_S = 3300


def fake_world(n_ranks: int) -> None:
    """Start this process's fake world of ``n_ranks`` (rank 0), or check
    the one it has."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(f"this process holds a world of "
                               f"{dist.get_world_size()} ranks, not "
                               f"{n_ranks}: one world a process")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def _local_bytes(tree) -> int:
    """This rank's bytes of a tree's (``DTensor``) leaves."""
    total = 0
    for t in tree_leaves(tree):
        if hasattr(t, "to_local"):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _storages(tree) -> set:
    out = set()
    for t in tree_leaves(tree):
        if hasattr(t, "to_local"):
            t = t.to_local()
        out.add(t.untyped_storage()._cdata)
    return out


def lower_case(arch: str, shape_name: str, *, multi_pod: bool,
               rules: ShardingRules | None = None, microbatches: int = 8,
               remat: bool = True, rules_profile: str = "baseline"):
    """``(case, meta)`` for one (arch x shape x mesh): ``case`` is ``(fn,
    args, mesh, rules)``, the step and its placed abstract arguments, or
    ``None`` with ``meta = {"skipped": reason}``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    model = Model(cfg)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    if rules is None:
        rules = ShardingRules().with_overrides(
            **RULE_PROFILES.get(rules_profile, {}))

    t0 = time.perf_counter()
    params_abs = model.init_abstract()
    logical = model.logical_specs()
    params = shard_params(params_abs, logical, mesh, rules)
    inputs = model.input_specs(shape)

    def placed(name, log):
        t = inputs[name]
        return distribute_tensor(t, mesh, spec_to_placements(
            rules.resolve(log, tuple(t.shape), mesh), mesh),
            src_data_rank=None)

    front = ({"frontend": placed("frontend", ("batch", "frontend", None))}
             if "frontend" in inputs else {})
    if shape.kind == "train":
        opt = shard_params(adamw_init(params_abs), adamw_opt_specs(logical),
                           mesh, rules)
        state = {"params": params, "opt": opt}
        mb = microbatches if shape.global_batch % microbatches == 0 else 1
        fn = make_train_step(model, AdamWConfig(), microbatches=mb,
                             remat=remat)
        batch = {k: placed(k, ("batch", "seq"))
                 for k in ("tokens", "labels", "loss_mask", "advantages")}
        args = (state, batch | front)
    elif shape.kind == "prefill":
        cache = shard_params(
            model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta"),
            model.cache_logical_specs(), mesh, rules)

        def fn(params, tokens, cache, frontend=None):
            return model.prefill(params, tokens, cache, frontend=frontend)
        args = (params, placed("tokens", ("batch", "seq")), cache,
                *front.values())
    else:                                       # decode
        ring = shape.name == "long_500k" and bool(cfg.sliding_window)
        cache = shard_params(inputs["cache"], model.cache_logical_specs(),
                             mesh, rules)

        def fn(params, token, cache):
            return model.decode_step(params, token, cache, ring=ring)
        args = (params, placed("token", ("batch", None)), cache)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "n_chips": mesh.size(), "lower_s": time.perf_counter() - t0,
            "params_b": cfg.param_count() / 1e9,
            "active_params_b": cfg.active_param_count() / 1e9}
    return (fn, args, mesh, rules), meta


def run_case(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = RESULTS_DIR, **kw) -> dict:
    """Lower and walk one case; write and return its record."""
    os.makedirs(out_dir, exist_ok=True)
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}_{shape_name}_{mesh_name}"
    path = os.path.join(out_dir, tag + ".json")
    try:
        case, meta = lower_case(arch, shape_name, multi_pod=multi_pod, **kw)
        if case is None:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "skipped", "why": meta["skipped"]}
        else:
            fn, args, mesh, rules = case
            arg_bytes = _local_bytes(args)
            arg_storage = _storages(args)
            t0 = time.perf_counter()
            with activation_sharding(mesh, rules), walk() as costs:
                out = fn(*args)
            meta["walk_s"] = time.perf_counter() - t0
            out_leaves = [t for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)]
            out_bytes = _local_bytes(out_leaves)
            alias = sum(_local_bytes([t]) for t in out_leaves
                        if _storages([t]) <= arg_storage)
            mem = memory_report(costs, argument_bytes=arg_bytes,
                                output_bytes=out_bytes, alias_bytes=alias)
            terms = analyze(costs, n_chips=meta["n_chips"],
                            model_flops=model_flops_for(
                                get_config(arch), SHAPES[shape_name]))
            print(f"[{tag}] memory: {mem}")
            print(f"[{tag}] walk: flops={terms.hlo_flops:.3e} "
                  f"bytes={terms.hlo_bytes:.3e} collective="
                  f"{terms.collective_bytes_per_chip:.3e} "
                  f"({meta['walk_s']:.1f}s)")
            rec = {"status": "ok", **meta, "memory": mem,
                   "roofline": terms.to_dict(), "walk": costs.summary()}
    except Exception as e:          # recorded for triage
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[{tag}] -> {rec['status']}", flush=True)
    return rec


def run_all(meshes, out_dir: str, *, force: bool = False,
            microbatches: int = 8, jobs: int = 1) -> dict:
    """Every arch x shape x mesh, one subprocess a case (a process holds
    one world), ``jobs`` of them at once, skipping cases with a record
    unless ``force``; returns ``{status: count}`` over all the records."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    os.makedirs(out_dir, exist_ok=True)
    todo, paths = [], []
    for a in list_archs():
        for s in SHAPES:
            for m in meshes:
                mesh_name = "multi" if m else "single"
                tag = f"{a}_{s}_{mesh_name}"
                path = os.path.join(out_dir, tag + ".json")
                paths.append(path)
                if os.path.exists(path) and not force:
                    with open(path) as f:
                        print(f"[{tag}] cached ({json.load(f)['status']})")
                    continue
                todo.append((a, s, mesh_name, path))

    def record(a, s, mesh_name, path, status, error=None):
        with open(path, "w") as f:
            json.dump({"arch": a, "shape": s, "mesh": mesh_name,
                       "status": status}
                      | ({"error": error} if error else {}), f)

    running = []
    while todo or running:
        while todo and len(running) < max(jobs, 1):
            a, s, mesh_name, path = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", mesh_name,
                   "--out", out_dir, "--microbatches", str(microbatches)]
            print("::", " ".join(cmd), flush=True)
            if os.path.exists(path):
                os.remove(path)
            running.append((subprocess.Popen(cmd, env=env), time.time(),
                            (a, s, mesh_name, path)))
        time.sleep(0.5)
        for item in list(running):
            proc, t0, case = item
            if proc.poll() is None and time.time() - t0 < CASE_TIMEOUT_S:
                continue
            running.remove(item)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                record(*case, "timeout")
            elif not os.path.exists(case[3]):     # the process died
                record(*case, "error", f"exit code {proc.returncode}, "
                                       f"no record written")
    statuses: dict = {}
    for path in paths:
        with open(path) as f:
            st = json.load(f)["status"]
        statuses[st] = statuses.get(st, 0) + 1
    return statuses


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cases run at once, one process each")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        t0 = time.perf_counter()
        statuses = run_all(meshes, args.out, force=args.force,
                           microbatches=args.microbatches, jobs=args.jobs)
        print(f"[dryrun] {sum(statuses.values())} cases in "
              f"{time.perf_counter() - t0:.0f}s: {statuses}")
        return 0 if set(statuses) <= {"ok", "skipped"} else 1
    if args.arch is None or args.shape is None or args.mesh == "both":
        ap.error("one case needs --arch, --shape and --mesh single|multi "
                 "(or --all)")
    rec = run_case(args.arch, args.shape, multi_pod=meshes[0],
                   out_dir=args.out, microbatches=args.microbatches)
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(_main())
