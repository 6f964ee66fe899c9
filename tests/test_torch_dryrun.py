"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) and its
report.

* In one spawned process holding a fake 256-rank world: internlm2-1.8b
  ``train_4k`` (one microbatch: the walk's time grows with the microbatch
  count, and the full sweep's 8 add nothing the test reads) and
  ``decode_32k``, and zamba2-2.7b ``prefill_32k``, on the single-pod
  ``(16, 16)`` mesh, each ``status == "ok"`` with finite, positive
  roofline terms and the step's kernels walked; each record's per-rank
  argument bytes equal the sum over the placed leaves (parameters, AdamW
  state, inputs, cache) of their local shard shapes resolved from the
  logical specs on a ``{data: 16, model: 16}`` mesh.
* ``long_500k`` on a full-attention arch is ``skipped`` with the
  reference's reason, with no world.
* ``--all`` over cached records exits 0 when every case is ok or skipped,
  1 when one errored.
* The port's ``roofline_table`` on synthetic records equals the
  reference's ``report.roofline_table`` on the same records.
"""
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

CASES = (("internlm2-1.8b", "train_4k", 1), ("internlm2-1.8b", "decode_32k",
                                              8),
         ("zamba2-2.7b", "prefill_32k", 8))
SIZES = {"data": 16, "model": 16}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _dryrun_rank(rank, out_dir):
    from repro_torch.launch.dryrun import run_case
    torch.set_num_threads(1)
    for arch, shape, mb in CASES:
        run_case(arch, shape, multi_pod=False, out_dir=out_dir,
                 microbatches=mb)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("dryrun")
    mp.start_processes(_dryrun_rank, args=(str(d),), nprocs=1,
                       start_method="spawn")
    return {(a, s): json.load(open(d / f"{a}_{s}_single.json"))
            for a, s, _ in CASES}


def _local_bytes(specs, tree, rules, mesh) -> int:
    """Sum over the leaves of their local shard bytes under the resolved
    specs."""
    from repro_torch.models.sharding import map_specs
    total = []

    def one(log, t):
        spec = rules.resolve(log, tuple(t.shape), mesh)
        n = 1
        for size, entry in zip(t.shape, spec):
            axes = () if entry is None else ((entry,) if isinstance(
                entry, str) else entry)
            n *= size // math.prod(SIZES[a] for a in axes)
        total.append(n * t.element_size())
    map_specs(one, specs, tree)
    return sum(total)


def _expected_argument_bytes(arch, shape_name) -> int:
    from repro_torch.configs import SHAPES
    from repro_torch.models import build_model
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.train.optimizer import adamw_init, adamw_opt_specs
    m, shape = build_model(arch), SHAPES[shape_name]
    rules, mesh = ShardingRules(), FakeMesh(SIZES)
    params, specs = m.init_abstract(), m.logical_specs()
    inputs = m.input_specs(shape)
    n = _local_bytes(specs, params, rules, mesh)
    if shape.kind == "train":
        n += _local_bytes(adamw_opt_specs(specs), adamw_init(params), rules,
                          mesh)
        names = ("tokens", "labels", "loss_mask", "advantages")
        return n + _local_bytes({k: ("batch", "seq") for k in names},
                                {k: inputs[k] for k in names}, rules, mesh)
    if shape.kind == "prefill":
        cache = m.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")
        return n + _local_bytes(m.cache_logical_specs(), cache, rules,
                                mesh) + _local_bytes(
            ("batch", "seq"), inputs["tokens"], rules, mesh)
    return n + _local_bytes(m.cache_logical_specs(), inputs["cache"], rules,
                            mesh) + _local_bytes(("batch", None),
                                                 inputs["token"], rules, mesh)


@pytest.mark.parametrize("arch,shape,mb", CASES)
def test_case_is_ok_with_its_terms(records, arch, shape, mb):
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["n_chips"] == 256 and rec["mesh"] == "single"
    t = rec["roofline"]
    for k in ("compute_s", "memory_s", "hlo_flops", "hlo_bytes",
              "model_flops", "step_time_s", "mfu"):
        assert math.isfinite(t[k]) and t[k] > 0, k
    assert t["bottleneck"] in ("compute", "memory", "collective")
    assert t["step_time_s"] == max(t["compute_s"], t["memory_s"],
                                   t["collective_s"])
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["resident_bytes"] >= mem["argument_size_in_bytes"]
    kernels = rec["walk"]["kernel_launches"]
    want = {"train_4k": "flash_attention", "decode_32k": "decode_attention",
            "prefill_32k": "mamba2_scan"}[shape]
    assert kernels.get(want, 0) > 0, kernels


@pytest.mark.parametrize("arch,shape,mb", CASES)
def test_argument_bytes_are_the_local_shards(records, arch, shape, mb):
    assert records[(arch, shape)]["memory"]["argument_size_in_bytes"] == \
        _expected_argument_bytes(arch, shape)


def test_long_500k_on_full_attention_is_skipped(tmp_path):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.configs import shape_applicable as ref_applicable

    from repro_torch.launch.dryrun import run_case
    rec = run_case("internlm2-1.8b", "long_500k", multi_pod=False,
                   out_dir=str(tmp_path))
    ok, why = ref_applicable(ref_config("internlm2-1.8b"),
                             REF_SHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": "internlm2-1.8b", "shape": "long_500k",
                   "mesh": "single", "status": "skipped", "why": why}
    assert json.load(open(tmp_path /
                          "internlm2-1.8b_long_500k_single.json")) == rec


@pytest.mark.parametrize("bad", [False, True])
def test_all_exit_code_over_cached_records(tmp_path, bad):
    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch.dryrun import _main
    for i, a in enumerate(list_archs()):
        for s in SHAPES:
            st = "error" if bad and i == 3 and s == "train_4k" else (
                "skipped" if s == "long_500k" else "ok")
            with open(tmp_path / f"{a}_{s}_single.json", "w") as f:
                json.dump({"arch": a, "shape": s, "mesh": "single",
                           "status": st}, f)
    assert _main(["--all", "--mesh", "single", "--out",
                  str(tmp_path)]) == (1 if bad else 0)


def _synthetic(arch, shape, status, i):
    rec = {"arch": arch, "shape": shape, "mesh": "single", "status": status}
    if status == "ok":
        rec["roofline"] = {
            "compute_s": 0.013 * (i + 1), "memory_s": 0.5 / (i + 1),
            "collective_s": 0.021 * i, "bottleneck": "memory",
            "hlo_flops": 3.7e12 * (i + 1), "hlo_bytes": 1.5e9 * (i + 2),
            "collective_bytes_per_chip": 2.5e8 * i,
            "useful_flop_ratio": 0.61 / (i + 1), "mfu": 0.123 / (i + 1),
            "step_time_s": 0.5 / (i + 1)}
        rec["memory"] = {"resident_bytes": 7.3e9 * (i + 1)}
    return rec


def test_roofline_table_equals_the_reference(tmp_path, monkeypatch):
    from repro.launch import report as ref_report

    from repro_torch.launch import report
    monkeypatch.chdir(tmp_path)
    recs = [_synthetic("a1", "train_4k", "ok", 0),
            _synthetic("a1", "long_500k", "skipped", 1),
            _synthetic("a2", "decode_32k", "ok", 2),
            _synthetic("a3", "prefill_32k", "error", 3),
            _synthetic("a4", "train_4k", "ok", 4)]
    for d in ("results/dryrun", report.RESULTS_DIR):
        os.makedirs(d)
        for r in recs:
            with open(os.path.join(d, f"{r['arch']}_{r['shape']}_single"
                                      f".json"), "w") as f:
                json.dump(r, f)
    assert report.roofline_table("single") == \
        ref_report.roofline_table("single")
    assert report.pick_hillclimb_candidates() == \
        ref_report.pick_hillclimb_candidates()
