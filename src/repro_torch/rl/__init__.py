from repro_torch.rl.rollout import (SamplerConfig, build_engine,
                                   generate_continuous, run_requests)

__all__ = ["SamplerConfig", "build_engine", "generate_continuous",
           "run_requests"]
