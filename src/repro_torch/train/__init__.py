from repro_torch.train.checkpoints import HostStateCache
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm,
                                         warmup_cosine)

__all__ = ["AdamWConfig", "HostStateCache", "adamw_init", "adamw_update",
           "global_norm", "warmup_cosine"]
