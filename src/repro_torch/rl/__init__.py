from repro_torch.rl.rollout import (SamplerConfig, build_engine,
                                   completions_to_text, generate_continuous,
                                   run_requests)

__all__ = ["SamplerConfig", "build_engine", "completions_to_text",
           "generate_continuous", "run_requests"]
