"""Model facade: one object per architecture exposing init, the training
forward, caches, prefill and the one-token decode steps (through the decode
attention kernels for GQA stacks, MoE ones included; plain for rwkv6,
zamba2 and deepseek-v2's MLA), plus the abstract parameters and inputs
(``meta`` tensors) that the dry-run places on the production meshes.
Counterpart of ``repro/models/model.py``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.models import kvcache
from repro_torch.models.common import AbstractGenerator
from repro_torch.models.stacks import (stack_forward, stack_init,
                                      stack_specs)
from repro_torch.models.stacks_infer import (kernel_supported,
                                             stack_decode_step,
                                             stack_kernel_decode_step,
                                             stack_prefill)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device."""
        return stack_init(generator, self.cfg)

    def init_abstract(self) -> dict:
        """:meth:`init`'s tree with the same shapes and dtypes as empty
        ``meta`` tensors; nothing is drawn (the init run on an
        :class:`~repro_torch.models.common.AbstractGenerator`)."""
        return stack_init(AbstractGenerator(), self.cfg)

    def logical_specs(self) -> dict:
        """:meth:`init`'s tree with each leaf's logical axes; a layer group
        is a list of per-layer specs (``models.stacks.stack_specs``)."""
        return stack_specs(self.cfg)

    def forward(self, params, tokens, *, frontend=None, remat: bool = False):
        """tokens (B, S) -> (logits (B, S, V) float32, aux scalar), the
        training forward of every family; ``frontend`` is a vlm's vision
        embeddings ``(B, F, d)`` or an audio model's frame embeddings ``(B,
        max_source_len, d)`` (:func:`~repro_torch.models.stacks.
        stack_forward`)."""
        return stack_forward(params, self.cfg, tokens, frontend=frontend,
                             remat=remat)

    def init_cache(self, batch: int, max_len: int, *, ring: bool = False,
                   device) -> dict:
        """Zeroed contiguous cache; ``ring=True`` allocates sliding-window
        ring buffers (:func:`~repro_torch.models.kvcache.init_cache`)."""
        return kvcache.init_cache(self.cfg, batch, max_len, ring=ring,
                                  device=device)

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

    def cache_logical_specs(self) -> dict:
        """:meth:`init_cache`'s tree with each leaf's logical axes."""
        return kvcache.cache_specs(self.cfg)

    def prefill(self, params, tokens, cache, *, frontend=None):
        """Fill ``cache`` from ``tokens (B, S)``; ``frontend`` is a vlm's
        vision embeddings ``(B, F, d)`` or an audio model's frame
        embeddings ``(B, max_source_len, d)``
        (:func:`~repro_torch.models.stacks_infer.stack_prefill`)."""
        return stack_prefill(params, self.cfg, tokens, cache,
                             frontend=frontend)

    def decode_step(self, params, token, cache, *, ring: bool = False):
        """One-token decode over a contiguous cache of any batch (a slot
        pool, a batch=1 view, the static ``generate`` batch): the dense
        family through the decode attention kernel, ssm, hybrid and MLA
        in plain PyTorch (an MLA batch's MoE rows routed together);
        ``ring=True`` decodes over a ring cache from
        ``init_cache(ring=True)``."""
        return stack_decode_step(params, self.cfg, token, cache, ring=ring)

    def kernel_supported(self) -> bool:
        """Whether :meth:`kernel_decode_step` serves this architecture on a
        contiguous cache (GQA stacks: dense, vlm, audio, MoE); the others
        decode through
        :meth:`decode_step`, but for the hybrid family's paged pool."""
        return kernel_supported(self.cfg)

    def kernel_decode_step(self, params, token, cache, *, tables=None):
        """Batched one-token decode over a whole slot pool through the
        decode attention kernels; ``tables`` selects the paged layout (the
        only one for the hybrid family, none for the ssm family).  An MLA
        model takes its plain absorbed step here on either layout, each
        slot's MoE rows routed alone (the serving pool's semantics)."""
        return stack_kernel_decode_step(params, self.cfg, token, cache,
                                        tables=tables)

    def input_specs(self, shape: InputShape) -> dict:
        """``meta`` stand-ins for every model input of this shape, with the
        JAX package's names, shapes and dtypes:

        train   -> {tokens, labels, loss_mask, advantages [, frontend]}
        prefill -> {tokens [, frontend]}
        decode  -> {token, cache}

        ``frontend`` is a vlm's ``(B, num_frontend_tokens, d)`` or an audio
        model's ``(B, max_source_len, d)`` float32 embeddings; the decode
        cache is :meth:`init_cache` on ``meta``, a ring cache for
        ``long_500k`` on a config with a sliding window."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def sds(size, dtype):
            return torch.empty(size, dtype=dtype, device="meta")
        i32, f32 = torch.int32, torch.float32
        front = {}
        if cfg.frontend == "vision":
            front["frontend"] = sds((B, cfg.num_frontend_tokens,
                                     cfg.d_model), f32)
        elif cfg.frontend == "audio":
            front["frontend"] = sds((B, cfg.max_source_len, cfg.d_model),
                                    f32)
        if shape.kind == "train":
            return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32),
                    "loss_mask": sds((B, S), f32),
                    "advantages": sds((B, S), f32)} | front
        if shape.kind == "prefill":
            return {"tokens": sds((B, S), i32)} | front
        if shape.kind == "decode":
            ring = shape.name == "long_500k" and bool(cfg.sliding_window)
            return {"token": sds((B, 1), i32),
                    "cache": self.init_cache(B, S, ring=ring,
                                             device="meta")}
        raise ValueError(shape.kind)


def build_model(arch: str | ModelConfig, *, reduced: bool = False) -> Model:
    """``reduced=True`` is the smoke-test variant in float32.  At full
    depth deepseek-v2-236b needs 235.7 B parameters (471 GB in bf16), more
    than one card holds: serve it ``reduced`` or as a cut (fewer layers)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    kvcache.check_supported(cfg)
    return Model(cfg)
