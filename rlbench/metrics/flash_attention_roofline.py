"""Flash attention's share of its roofline in the traced span: the sum of
each launch's least time (its operations at peak, or its bytes at the
memory rate, whichever is longer) over the device time of the
``flash_fwd`` kernels in the trace, in percent."""
from rlbench.harness.readers import roofline


def read(obs):
    return roofline(obs["flash"])
