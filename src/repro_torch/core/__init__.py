"""RollMux core: the paper's scheduling contribution (the planner) and the
phase-centric execution plane.  Counterpart of ``repro/core``; the port
also exports its CUDA stream helpers."""
from repro_torch.core.cluster import (H20, H800, V5E, GPUS_PER_NODE,
                                      HOST_MEM_GB, AcceleratorType, Node,
                                      NodeAllocator)
from repro_torch.core.job import RLJob, from_profile
from repro_torch.core.group import (CoExecutionGroup, Placement, SimResult,
                                    SwitchCosts)
from repro_torch.core.inter_group import Decision, InterGroupScheduler
from repro_torch.core.baselines import (GavelPlus, GreedyMostIdle,
                                        RandomScheduler, SoloDisaggregation,
                                        VeRLColocated, offline_optimal_cost)
from repro_torch.core.simulator import (ClusterSimulator, Report,
                                        group_from_profiles, replay_verl,
                                        simulate_profiles)
from repro_torch.core.phase_control import (PermitPool, PhaseProfile,
                                            PhaseStats, PhaseStreams,
                                            RollMuxRuntime, hand_over,
                                            sync_current_stream, take_over)
from repro_torch.core.telemetry import MetricsSnapshot
from repro_torch.core import distributions, theory, trace

__all__ = [
    "H20", "H800", "V5E", "GPUS_PER_NODE", "HOST_MEM_GB", "AcceleratorType",
    "Node", "NodeAllocator", "RLJob", "from_profile", "CoExecutionGroup",
    "Placement", "SimResult", "SwitchCosts", "Decision", "InterGroupScheduler",
    "GavelPlus", "GreedyMostIdle", "RandomScheduler", "SoloDisaggregation",
    "VeRLColocated", "offline_optimal_cost", "ClusterSimulator", "Report",
    "group_from_profiles", "replay_verl", "simulate_profiles", "PermitPool",
    "PhaseProfile", "PhaseStats", "PhaseStreams", "RollMuxRuntime",
    "hand_over", "sync_current_stream", "take_over", "MetricsSnapshot",
    "distributions", "theory", "trace",
]
