"""Milliseconds of one decode step of the co-executed jobs' rollout
engines in the window: their decode time (a host clock around each
tick's graph replay, which ends in the tick's copy to the host) over
their decode steps."""
from rlbench.harness.readers import decode_ms


def read(obs):
    return decode_ms(obs)
