"""Model facade: one object per architecture exposing init, the training
forward, caches, prefill and the batched kernel decode step.  Counterpart of
``repro/models/model.py``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import kvcache
from repro_torch.models.stacks import stack_forward, stack_init
from repro_torch.models.stacks_infer import (stack_kernel_decode_step,
                                             stack_prefill)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device."""
        return stack_init(generator, self.cfg)

    def forward(self, params, tokens, *, remat: bool = False):
        """tokens (B, S) -> (logits (B, S, V) float32, aux scalar)."""
        return stack_forward(params, self.cfg, tokens, remat=remat)

    def init_cache(self, batch: int, max_len: int, *, device) -> dict:
        return kvcache.init_cache(self.cfg, batch, max_len, device=device)

    def init_paged_cache(self, num_slots: int, max_len: int, *,
                         block_size: int, num_blocks: int,
                         kv_dtype: str | None = None, device) -> dict:
        return kvcache.init_paged_cache(
            self.cfg, num_slots, max_len, block_size=block_size,
            num_blocks=num_blocks, kv_dtype=kv_dtype, device=device)

    def paged_cache_names(self) -> tuple[str, ...]:
        return kvcache.paged_names(self.cfg)

    def scale_cache_names(self) -> tuple[str, ...]:
        return kvcache.scale_names(self.cfg)

    def prefill(self, params, tokens, cache):
        return stack_prefill(params, self.cfg, tokens, cache)

    def kernel_decode_step(self, params, token, cache, *, tables=None):
        """Batched one-token decode over a whole slot pool through the
        decode attention kernels; ``tables`` selects the paged layout."""
        return stack_kernel_decode_step(params, self.cfg, token, cache,
                                        tables=tables)


def build_model(arch: str | ModelConfig, *, reduced: bool = False) -> Model:
    """``reduced=True`` is the smoke-test variant in float32."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    kvcache.check_supported(cfg)
    return Model(cfg)
