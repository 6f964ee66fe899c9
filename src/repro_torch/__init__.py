"""PyTorch/CUDA port of the RollMux reproduction.

The JAX package ``repro`` stays the reference; this package grows beside it
slice by slice, with the same module layout, and imports nothing of it.
Each TPU kernel of a ported path becomes a hand-written Hopper kernel in
``repro_torch.kernels`` (built from ``kernels/csrc`` at first use), with a
plain PyTorch version beside it that the CPU tests and the chip smoke use
as its reference.
"""
