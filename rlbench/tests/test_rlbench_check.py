"""The check at a test size on the CPU: each cell's sound run is correct
under the committed limits, and a run with the timed path broken
underneath (a step that returns its state unchanged, half of the batch
left out, a token altered where it is produced) or with the float8
reference in the program's place (the control) is not; and a program
whose model departs from the configuration's file is refused."""
import json
import time

import pytest
import torch

from rlbench import run as R

CELLS = [w["name"] for w in json.loads(
    (R.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small(cell):
    """The cell's files with its traffic cut to a test size, and the
    reduced model of its configuration with a configuration that states
    it."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from rlbench.harness.config import file_view
    files = R.cell_files(cell)
    files.workload.update(prompts=2, group=4, max_new=8, prompt_len=16,
                          content_len=[4, 12], slots=4)
    files.workload["check"] = dict(files.workload["check"], rows_per_block=4)
    model = Model(get_config(files.config["port_arch"]).reduced())
    files.config = {**files.config, **file_view(model.cfg)}
    return files, model


def run_small(cell, seed, **kw):
    files, model = small(cell)
    return R.run_cell(files, seed=seed, seconds=0.5, trace=False,
                      device=torch.device("cpu"), t_start=time.perf_counter(),
                      model=model, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell, 2**31 + 11)
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half", "token"])
def test_broken_timed_path_is_not_correct(cell, fault):
    res = run_small(cell, 2**31 + 12, fault=fault)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_small(cell, 2**31 + 13, control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell,rate", [
    ("internlm2-grpo-solo", "grpo_tokens_per_s"),
    ("internlm2-grpo-coexec2", "mux_tokens_per_s")])
def test_result_line_keys(cell, rate):
    files, _ = small(cell)
    res = run_small(cell, 2**31 + 14)
    line = R.result_line(files, res, False, "cpu")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared" and "breakdown" not in line
    assert set(line["metrics"]) == {rate, "setup_s"}
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in line["device"]
    json.dumps(line)


def test_a_model_unlike_the_file_is_refused():
    files, model = small("internlm2-grpo-solo")
    files.config = {**files.config,
                    "intermediate_size": files.config["intermediate_size"] * 2}
    with pytest.raises(R.Refused, match="intermediate_size") as e:
        R.run_cell(files, seed=2**31 + 16, seconds=0.5, trace=False,
                   device=torch.device("cpu"), t_start=time.perf_counter(),
                   model=model)
    assert e.value.code == 5


def test_window_iterations_follow_the_seconds():
    files, _ = small("internlm2-grpo-solo")
    run_s = files.bench["run_seconds"]
    n = files.workload["window_iterations"]
    res = R.run_cell(files, seed=2**31 + 17, seconds=run_s * 1.5 / n,
                     trace=False, device=torch.device("cpu"),
                     t_start=time.perf_counter(), model=small(
                         "internlm2-grpo-solo")[1])
    assert res["info"]["iterations"] == 2
