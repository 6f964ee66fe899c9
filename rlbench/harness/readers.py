"""Arithmetic the per-layer readers share."""
from __future__ import annotations

from rlbench.harness.work import PEAK


def decode_ms(obs):
    """Decode milliseconds a step over the window's engine counters."""
    d = obs.get("decode") or []
    steps = sum(n for _, n in d)
    return 1e3 * sum(s for s, _ in d) / steps if steps else None


def mean_train_s(obs):
    """Mean host seconds of the window's train phases."""
    ts = obs.get("train_s") or []
    return sum(ts) / len(ts) if ts else None


def mfu(obs):
    """Percent of the dense bf16 peak that the window's model FLOPs take
    over its seconds."""
    if not obs.get("window_s"):
        return None
    return 100.0 * obs["model_flops"] / (obs["window_s"] * PEAK["bfloat16"])


def roofline(kernel: dict):
    """Percent of a kernel's roofline: summed least times over its device
    time; nothing when it did not run in the traced span."""
    if not kernel.get("calls") or kernel.get("device_s", 0) <= 0:
        return None
    return 100.0 * kernel["bound_s"] / kernel["device_s"]


def idle_share(obs):
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
