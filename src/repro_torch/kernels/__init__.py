"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by ``_build``)
with a plain PyTorch version beside each: ``decode_attention`` (contiguous
and paged decode attention) and ``sampling`` (greedy sampling)."""
