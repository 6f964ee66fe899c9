"""Render the roofline table from ``results/dryrun_torch/*.json``.

Counterpart of ``repro/launch/report.py``, with its table and candidate
picks over the port's dry-run records (``launch/dryrun.py``).  The columns
keep the reference's names: "HLO" is the cost walk's per-rank count here,
and every time is a modelled H100 term, not a card time.

    PYTHONPATH=src python -m repro_torch.launch.report [single|multi]
"""
from __future__ import annotations

import glob
import json
import os

RESULTS_DIR = "results/dryrun_torch"


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def load(mesh: str, d=RESULTS_DIR):
    out = []
    for f in sorted(glob.glob(os.path.join(d, f"*_{mesh}.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def roofline_table(mesh: str = "single", d=RESULTS_DIR) -> str:
    rows = []
    hdr = ("| arch | shape | compute s | memory s | collective s | bottleneck "
           "| HLO GFLOP/chip | HLO bytes/chip | coll bytes/chip | useful ratio "
           "| MFU | resident/chip |")
    sep = "|" + "---|" * 12
    rows.append(hdr)
    rows.append(sep)
    for r in load(mesh, d):
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skipped (sub-quadratic rule) | — | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"{r['status']} | — | — | — | — | — | — |")
            continue
        t = r["roofline"]
        mem = r["memory"]["resident_bytes"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3g} | "
            f"{t['memory_s']:.3g} | {t['collective_s']:.3g} | "
            f"**{t['bottleneck']}** | {t['hlo_flops']/1e9:.0f} | "
            f"{fmt_bytes(t['hlo_bytes'])} | "
            f"{fmt_bytes(t['collective_bytes_per_chip'])} | "
            f"{t['useful_flop_ratio']:.2f} | {t['mfu']*100:.1f}% | "
            f"{fmt_bytes(mem)} |")
    return "\n".join(rows)


def pick_hillclimb_candidates(d=RESULTS_DIR):
    """worst roofline fraction (MFU), most collective-bound, most
    representative of the paper's technique."""
    recs = [r for r in load("single", d) if r["status"] == "ok"]
    by_mfu = sorted(recs, key=lambda r: r["roofline"]["mfu"])
    by_coll = sorted(recs, key=lambda r: -(r["roofline"]["collective_s"] /
                                           max(r["roofline"]["step_time_s"], 1e-12)))
    return {
        "worst_mfu": [(r["arch"], r["shape"], r["roofline"]["mfu"])
                      for r in by_mfu[:6]],
        "most_collective": [(r["arch"], r["shape"],
                             r["roofline"]["collective_s"] /
                             max(r["roofline"]["step_time_s"], 1e-12))
                            for r in by_coll[:6]],
    }


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(roofline_table(mesh))
    print()
    print(json.dumps(pick_hillclimb_candidates(), indent=1))
