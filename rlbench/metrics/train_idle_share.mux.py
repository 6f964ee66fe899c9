"""The share of the traced span (the first job's last train phase in the
window, with the other job's rollout beside it) in which no operation
ran on the device, in percent."""
from rlbench.harness.readers import idle_share


def read(obs):
    return idle_share(obs)
