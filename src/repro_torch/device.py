"""Device resolution shared by the port's entry points.

Every entry point (``Engine``, ``generate_continuous``, ``serve_continuous``,
the CLI) runs on the CUDA card unless the caller asks for the CPU with
``device="cpu"``.  There is no silent fallback: with no card and no explicit
device, :func:`resolve_device` raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises when there is none);
    anything else -> that device, with a CUDA index made explicit so that
    ``tensor.device == resolve_device(...)`` compares like with like."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
