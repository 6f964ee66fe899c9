"""Milliseconds of one decode step of the rollout engine in the window:
the engines' decode time (a host clock around each tick's graph replay,
which ends in the tick's copy to the host) over their decode steps."""
from rlbench.harness.readers import decode_ms


def read(obs):
    return decode_ms(obs)
