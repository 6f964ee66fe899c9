"""The harness's arithmetic on synthetic timelines: a stall inside the
window must move the rate and the idle share."""
import pytest

from rlbench import run as R
from rlbench.harness import readers
from rlbench.harness.stats import (idle_gaps, merged, reclaimed_bubble_frac,
                                   union_s)


def test_union_and_merge():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_s(ivs) == pytest.approx(4.0)
    assert merged(ivs) == [(0, 3), (5, 6)]
    assert union_s([]) == 0.0


def test_reclaimed_bubble():
    # back to back: nothing reclaimed
    assert reclaimed_bubble_frac({"rollout": [(0, 2)],
                                  "train": [(2, 3)]}) == pytest.approx(0.0)
    # the train phase wholly hidden under a rollout: all of it
    assert reclaimed_bubble_frac({"rollout": [(0, 2)],
                                  "train": [(0.5, 1.5)]}) == pytest.approx(1)
    # half hidden
    assert reclaimed_bubble_frac({"rollout": [(0, 2)],
                                  "train": [(1.5, 2.5)]}) == pytest.approx(.5)
    assert reclaimed_bubble_frac({"rollout": [(0, 2)]}) is None


def test_rate_falls_with_a_stall():
    # tokens over a window that holds whole iterations
    tokens, window = 16384 * 4, 12.0
    assert tokens / (window + 1.0) < tokens / window


def test_idle_share_and_gaps():
    busy = merged([(0.0, 1.0), (1.5, 3.0), (2.0, 2.5)])
    gaps = idle_gaps(busy, 0.0, 4.0)
    assert gaps == [(3.0, 4.0), (1.0, 1.5)]
    obs = {"trace": {"busy_s": sum(b - a for a, b in busy), "window_s": 4.0}}
    share = readers.idle_share(obs)
    assert share == pytest.approx(37.5)
    stalled = {"trace": {"busy_s": obs["trace"]["busy_s"], "window_s": 5.0}}
    assert readers.idle_share(stalled) > share


def test_decode_and_roofline_readers():
    assert readers.decode_ms({"decode": [(1.0, 200), (1.2, 200)]}) \
        == pytest.approx(5.5)
    assert readers.decode_ms({"decode": []}) is None
    assert readers.roofline({"calls": 3, "bound_s": 1.0, "device_s": 4.0}) \
        == pytest.approx(25.0)
    # a kernel that did not run reads nothing, never 0
    assert readers.roofline({"calls": 0, "bound_s": 0.0,
                             "device_s": 0.0}) is None


def test_metric_readers_read_observations():
    obs = {"reclaimed": 0.8, "restores": [(4e9, 0.2), (4e9, 0.3)],
           "decode": [(1.0, 200)], "train_s": [1.0, 2.0],
           "model_flops": 989e12 * 0.5, "window_s": 10.0,
           "trace": {"busy_s": 9.0, "window_s": 10.0},
           "flash": {"calls": 2, "bound_s": 0.5, "device_s": 1.0}}
    assert R.reader("reclaimed_bubble_frac.mux")(obs) == 0.8
    assert R.reader("restore_gb_s.mux")(obs) == pytest.approx(16.0)
    assert R.reader("flash_attention_roofline")(obs) == pytest.approx(50.0)
    for suffix in ("grpo", "mux"):
        assert R.reader(f"decode_ms_per_step.{suffix}")(obs) \
            == pytest.approx(5.0)
        assert R.reader(f"train_phase_s.{suffix}")(obs) == pytest.approx(1.5)
        assert R.reader(f"mfu.{suffix}")(obs) == pytest.approx(5.0)
        assert R.reader(f"train_idle_share.{suffix}")(obs) \
            == pytest.approx(10.0)
    idle = {"flash": {"calls": 0, "bound_s": 0.0, "device_s": 0.0}}
    assert R.reader("flash_attention_roofline")(idle) is None
