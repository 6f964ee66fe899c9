"""Continuous-batching rollout serving: requests, queue, admission
policies, KV slot managers, the engine with radix prefix sharing,
disaggregated prefill/decode serving and elastic capacity.  See
``serve.engine``."""
from repro_torch.serve.blocks import BlockAllocator, blocks_for
from repro_torch.serve.disagg import KVTransferHandle, PrefillEngine
from repro_torch.serve.elastic import (ElasticConfig, ElasticController,
                                       rederive_slo, resize_engine,
                                       resize_router)
from repro_torch.serve.engine import (Engine, EngineConfig, EngineStats,
                                      SuspendedRequest, run_trace)
from repro_torch.serve.protocol import ENGINE_ATTRS, EngineProtocol
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.radix import PrefixMatch, RadixNode, RadixPrefixIndex
from repro_torch.serve.request import Request, RequestOutput
from repro_torch.serve.router import DisaggConfig, DisaggRouter, RouterStats
from repro_torch.serve.sched import (DeadlinePolicy, FIFOPolicy,
                                     SchedulerPolicy, SLOPolicy, make_policy)
from repro_torch.serve.slots import PagedSlotManager, SlotManager
from repro_torch.serve.spec import RolloutSpec

__all__ = ["BlockAllocator", "blocks_for", "Engine", "EngineConfig",
           "EngineStats", "RequestQueue", "Request", "RequestOutput",
           "SchedulerPolicy", "FIFOPolicy", "DeadlinePolicy", "SLOPolicy",
           "make_policy", "PagedSlotManager", "SlotManager",
           "SuspendedRequest", "run_trace", "PrefixMatch", "RadixNode",
           "RadixPrefixIndex", "KVTransferHandle", "PrefillEngine",
           "DisaggConfig", "DisaggRouter", "RouterStats", "EngineProtocol",
           "ENGINE_ATTRS", "RolloutSpec", "ElasticConfig",
           "ElasticController", "resize_engine", "resize_router",
           "rederive_slo"]
