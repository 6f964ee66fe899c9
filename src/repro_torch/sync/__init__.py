"""Topology-aware weight sync between the training and rollout pools
(paper §5.2).  Counterpart of ``repro/sync``: ``sync_collective_bytes``
takes the place of the reference's ``lower_sync`` (which lowers a sync to
HLO to count its collective bytes)."""
from repro_torch.sync.topology import ClusterTopology
from repro_torch.sync.model_sync import (flat_sync_baseline, flatten_params,
                                         hierarchical_sync, make_sync_mesh,
                                         sync_collective_bytes,
                                         sync_params_between_jobs,
                                         unflatten_params)

__all__ = ["ClusterTopology", "flat_sync_baseline", "flatten_params",
           "hierarchical_sync", "make_sync_mesh", "sync_collective_bytes",
           "sync_params_between_jobs", "unflatten_params"]
