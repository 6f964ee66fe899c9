#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 rlbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads`` entry of that name) names its
configuration and its traffic mix.  Their files hold every size: the
configuration's (the entry's ``file``), the mix's
``rlbench/traffic/<traffic>.json`` (whose ``driver`` names the harness
module that runs it, ``rlbench/harness/<driver>.py``) and the cell's own
``rlbench/workloads/<name>.json`` (its window's iterations and the
limits of its check).  The configuration's file states the model: the
program's is held against it, and the run refuses to go on where they
differ.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by its own reader ``rlbench/metrics/<name>.py``.  The last lines on
standard error, and the result line's last key, give each number the
check compared beside its limit.

The run needs as many CUDA cards as the cell asks for, and exits with
another code than 0, printing no result, without them; so it does when
JAX or the JAX package has been loaded by the time the window closes.
Every cache the program builds lives inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "rlbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that must print no result, with its exit code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The manifest, the cell, its configuration and its traffic, found by
    name."""
    manifest_path = root / "BENCHMARK.json"
    if not manifest_path.exists():
        raise Refused(2, f"no {manifest_path}")
    bench = load_json(manifest_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(2, f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    entry = cfgs[cell["config"]]
    traffic = load_json(root / "rlbench" / "traffic" / f"{cell['traffic']}.json")
    own = load_json(root / "rlbench" / "workloads" / f"{name}.json")
    return SimpleNamespace(bench=bench, cell=cell,
                           config=load_json(root / entry["file"]),
                           workload={**traffic, **own})


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    """The ``read`` function of the per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rlbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, e2e=None) -> bool:
    """Whether a metric is reported in ``cell``: its ``workloads`` list it;
    without the key, an end-to-end metric always is, a per-layer one where
    the cell reports the metric it moves (``e2e``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e is None or metric["moves"] in e2e


def metrics_of(files, res: dict, trace: bool) -> dict:
    """The line's metrics: the cell's end-to-end ones, or (traced) its
    per-layer ones that found something to read."""
    name = files.cell["name"]
    e2e = [m for m in files.bench["end_to_end"] if applies(m, name)]
    out = {}
    if not trace:
        for m in e2e:
            out[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
        return out
    names = {m["name"] for m in e2e}
    for m in files.bench["per_layer"]:
        if not applies(m, name, names):
            continue
        v = reader(m["name"])(res["layers"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def setup_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout; the program's own
    kernel build directory is ``build/`` there already."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(files, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, model=None, fault=None, control=False) -> dict:
    """Run the cell on ``device`` and return the driver's result, with
    ``correct`` and the compared rows added; a program whose model departs
    from the configuration's file is refused."""
    from rlbench.harness import check
    from rlbench.harness.config import ConfigMismatch
    driver = importlib.import_module(
        f"rlbench.harness.{files.workload['driver']}")
    ctx = SimpleNamespace(workload=files.workload, config=files.config,
                          seed=seed, seconds=seconds,
                          run_seconds=files.bench["run_seconds"], trace=trace,
                          device=device, t_start=t_start, model=model,
                          fault=fault, control=control)
    try:
        res = driver.run(ctx)
    except ConfigMismatch as e:
        raise Refused(5, str(e)) from None
    res["correct"], res["compared"] = check.verdict(
        res["numbers"], files.workload["check"]["limits"])
    return res


def result_line(files, res: dict, trace: bool, kind: str,
                power: str = "") -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, the
    metrics, the device (with the traced span's busy and window seconds),
    a traced run's breakdown, then ``compared`` last."""
    line = {
        "correct": bool(res["correct"]),
        "attempted": res["attempted"], "failed": res["failed"],
        "metrics": metrics_of(files, res, trace),
        "device": {"platform": "gpu", "kind": kind,
                   "count": files.cell["chips"],
                   "memory_peak_bytes": int(res["peak"]),
                   "power_limit": power},
    }
    if trace:
        tr = res["layers"]["trace"]
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["top_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["info"] = res.get("info", {})
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in res["compared"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        files = cell_files(args.workload)
        setup_env()
        import torch
        from rlbench.harness.config import ConfigMismatch
        chips = files.cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(3, f"the cell needs {chips} CUDA card(s); "
                             f"{torch.cuda.device_count()} available")
        dev = torch.device("cuda", 0)
        res = run_cell(files, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=dev, t_start=T_START)
        found = forbidden_modules()
        if found:
            raise Refused(4, f"loaded after the window: {', '.join(found)}")
    except Refused as e:
        print(f"rlbench: {e}", file=sys.stderr)
        return e.code
    except ConfigMismatch as e:
        print(f"rlbench: {e}", file=sys.stderr)
        return 5
    line = result_line(files, res, bool(args.trace),
                       torch.cuda.get_device_name(dev), power_limit())
    for n, v, lim in res["compared"]:
        print(f"compared {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
