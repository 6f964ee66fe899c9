from repro_torch.core.phase_control import (PermitPool, PhaseProfile,
                                            PhaseStats, PhaseStreams,
                                            RollMuxRuntime, hand_over,
                                            sync_current_stream, take_over)

__all__ = ["PermitPool", "PhaseProfile", "PhaseStats", "PhaseStreams",
           "RollMuxRuntime", "hand_over", "sync_current_stream", "take_over"]
