"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by ``_build``)
with a plain PyTorch version beside each: ``decode_attention`` (contiguous
and paged decode attention), ``sampling`` (greedy sampling and top-k),
``flash_attention`` (the causal forward), ``rwkv6_scan`` (the chunked WKV
recurrence) and ``mamba2_scan`` (the chunked SSD recurrence)."""
