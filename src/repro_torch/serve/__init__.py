"""Continuous-batching rollout serving: requests, queue, admission
policies, KV slot managers and the engine.  See ``serve.engine``."""
from repro_torch.serve.blocks import BlockAllocator, blocks_for
from repro_torch.serve.engine import Engine, EngineConfig, EngineStats
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request, RequestOutput
from repro_torch.serve.sched import (DeadlinePolicy, FIFOPolicy,
                                     SchedulerPolicy, SLOPolicy, make_policy)
from repro_torch.serve.slots import PagedSlotManager, SlotManager

__all__ = ["BlockAllocator", "blocks_for", "Engine", "EngineConfig",
           "EngineStats", "RequestQueue", "Request", "RequestOutput",
           "SchedulerPolicy", "FIFOPolicy", "DeadlinePolicy", "SLOPolicy",
           "make_policy", "PagedSlotManager", "SlotManager"]
