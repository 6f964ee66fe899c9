from repro_torch.rl.agentic import (CountdownToolEnv, Environment, Episode,
                                   Turn, run_episodes)
from repro_torch.rl.rollout import (SamplerConfig, completions_to_text,
                                   generate, generate_continuous,
                                   run_requests)

__all__ = ["SamplerConfig", "completions_to_text", "generate",
           "generate_continuous", "run_requests", "CountdownToolEnv",
           "Environment", "Episode", "Turn", "run_episodes"]
