"""Mean seconds of one train phase in the window (a host clock around
``GRPOJob.train_phase``, which ends in its stream's sync)."""
from rlbench.harness.readers import mean_train_s


def read(obs):
    return mean_train_s(obs)
