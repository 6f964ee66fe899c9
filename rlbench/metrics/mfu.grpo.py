"""The window's model FLOPs (6 N a trained position, 2 N a prefilled or
generated token) over the window's seconds at the H100's dense bf16 peak,
in percent."""
from rlbench.harness.readers import mfu


def read(obs):
    return mfu(obs)
