"""The harness on the card at a test size: a traced run of each cell
reads device time from the profiler, and its check holds (and a fault
fails it).  Skips without a CUDA card."""
import time

import pytest

from rlbench import run as R
from test_rlbench_check import CELLS, small

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(card, cell):
    files, model = small(cell)
    res = R.run_cell(files, seed=2**31 + 21, seconds=0.5, trace=True,
                     device=card, t_start=time.perf_counter(), model=model)
    assert res["correct"], res["compared"]
    tr = res["layers"]["trace"]
    assert 0 < tr["busy_s"] <= tr["window_s"] * 1.001
    line = R.result_line(files, res, True, "card")
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_token_fault_on_the_card(card):
    files, model = small("internlm2-grpo-solo")
    res = R.run_cell(files, seed=2**31 + 22, seconds=0.5, trace=False,
                     device=card, t_start=time.perf_counter(), model=model,
                     fault="token")
    assert not res["correct"]
