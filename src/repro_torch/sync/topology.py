"""Cluster network topology + analytic transfer-time model (paper §5.2, §7.1).

Counterpart of ``repro/sync/topology.py``, copied as it is (pure Python).
Defaults follow the paper's testbed: 400 Gbps InfiniBand inside each cluster,
a 20 Gbps Ethernet link between the rollout and training clusters.  The
times are the paper's modelled link times, not measurements.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ClusterTopology:
    inter_cluster_gbps: float = 20.0       # cross-cluster Ethernet
    intra_cluster_gbps: float = 400.0      # IB / NVLink fabric
    nvlink_gbps: float = 3200.0            # intra-node NVLink (8-GPU node)
    p2p_streams: int = 8                   # parallel cross-link streams
    stream_efficiency: float = 0.92

    # ---- baseline: veRL-style flat collectives -----------------------------
    def flat_fetch_time_s(self, model_bytes: float, n_rollout_gpus: int) -> float:
        """Every rollout GPU independently fetches a full copy across the
        slow link (single-node veRL behaviour, Fig 8-top / Fig 12-left)."""
        bits = model_bytes * 8 * n_rollout_gpus
        return bits / (self.inter_cluster_gbps * 1e9 * self.stream_efficiency)

    def ring_allgather_time_s(self, model_bytes: float, n_total_gpus: int)\
            -> float:
        """Multi-node flat all-gather ring spanning both clusters: the ring
        crosses the slow boundary twice, each crossing carrying ~the full
        model (Fig 12-right baseline)."""
        bits = model_bytes * 8 * 2 * (n_total_gpus - 1) / n_total_gpus
        return bits / (self.inter_cluster_gbps * 1e9 * self.stream_efficiency)

    # ---- RollMux hierarchical two-stage transfer ----------------------------
    def hierarchical_time_s(self, model_bytes: float, n_train_gpus: int,
                            n_rollout_gpus: int) -> float:
        """Stage 1: exactly one model copy crosses the slow link as
        n_train parallel P2P shard streams. Stage 2: intra-cluster
        all-gather over the fast fabric."""
        stage1 = (model_bytes * 8
                  / (self.inter_cluster_gbps * 1e9 * self.stream_efficiency))
        ag_bytes = model_bytes * (n_rollout_gpus - 1) / n_rollout_gpus
        stage2 = ag_bytes * 8 / (self.intra_cluster_gbps * 1e9
                                 * self.stream_efficiency)
        return stage1 + stage2

    def speedup_single_node(self, model_bytes: float, n: int = 8) -> float:
        return (self.flat_fetch_time_s(model_bytes, n)
                / self.hierarchical_time_s(model_bytes, n, n))

    def speedup_multi_node(self, model_bytes: float, n: int = 16) -> float:
        return (self.ring_allgather_time_s(model_bytes, 2 * n)
                / self.hierarchical_time_s(model_bytes, n, n))

    # ---- cold vs warm start (paper Fig 4 / C3) ------------------------------
    def cold_start_s(self, state_bytes: float, *, control_plane_s: float = 18.0)\
            -> float:
        """Re-fetch weights/optimizer across the slow link + control-plane
        re-init (NCCL communicators, dataset pipeline, env handles)."""
        xfer = state_bytes * 8 / (self.inter_cluster_gbps * 1e9
                                  * self.stream_efficiency)
        return xfer + control_plane_s

    def warm_start_s(self, state_bytes: float,
                     host_to_device_gbps: float = 200.0,
                     wake_overhead_s: float = 0.8) -> float:
        """Host-DRAM -> HBM reload over PCIe/DMA (8 GPUs in parallel);
        control plane retained by the sleeping process (paper §5.1)."""
        return state_bytes * 8 / (host_to_device_gbps * 1e9) + wake_overhead_s
