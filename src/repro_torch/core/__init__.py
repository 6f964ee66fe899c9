from repro_torch.core.phase_control import (PermitPool, PhaseProfile,
                                            PhaseStats, RollMuxRuntime)

__all__ = ["PermitPool", "PhaseProfile", "PhaseStats", "RollMuxRuntime"]
