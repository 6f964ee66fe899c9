"""Request/response records for the continuous-batching rollout engine.

A :class:`Request` is one generation job: a token prompt plus per-request
decode budget (and optional sampling key / modality frontend embeddings).
The engine turns it into a :class:`RequestOutput` whose per-token behaviour
logprobs follow exactly the semantics of ``rl.rollout.generate`` — the
token that triggers EOS is still recorded (mask 1), everything after it is
dropped — so GRPO training consumes engine output unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int32 token sequence (already BOS'd / padded however
    the caller likes — the engine treats it verbatim, like ``generate`` does
    a batch row).  ``max_new_tokens`` is this request's decode budget;
    generation stops at the first EOS or when the budget is exhausted,
    whichever comes first.  ``arrival_time`` is only meaningful to trace
    drivers (``run_trace`` in the JAX package); the engine itself is
    clock-free.

    The admission-policy fields (``repro_torch.serve.sched``) are all optional
    and ignored by ``FIFOPolicy``: ``priority`` breaks deadline ties
    (higher = more urgent), ``deadline`` is an absolute driver-clock time
    the request should finish by (``DeadlinePolicy`` orders admission by
    it; ``SLOPolicy`` derives one from the group's slowdown bound when
    unset), and ``job_id`` names the submitting job for per-job token
    budgets.  ``prefix_key`` is an optional prefix-sharing *isolation
    namespace* for the radix tree, and ``stop_tokens`` turn a request
    multi-turn (suspend at a tool boundary instead of finishing).  Both
    keep the JAX package's meaning; the port's engine does not serve
    radix sharing or suspension yet and refuses ``stop_tokens``.
    """
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_time: float = 0.0
    frontend: Optional[Any] = None       # (1, F, d) modality embeddings
    priority: int = 0                    # higher = more urgent (sched tiebreak)
    deadline: Optional[float] = None     # absolute driver-clock finish target
    prefix_key: Optional[Any] = None     # radix isolation namespace
    #                                      (None = global content sharing)
    job_id: Optional[str] = None         # submitting job (per-job budgets)
    stop_tokens: tuple = ()              # tool-boundary ids -> suspend, not
    #                                      finish (serve.engine suspend API)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.stop_tokens = tuple(int(t) for t in self.stop_tokens)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_budget(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclass
class RequestOutput:
    """Completed request: generated tokens + per-token behaviour logprobs.

    ``token_versions`` records, per generated token, the engine weight
    version whose logits the token was sampled from — the provenance
    partial-rollout continuation needs: a generation carried across a
    weight sync (``Engine.reset(carry_live=True)``) mixes versions, and
    the clipped importance-ratio diagnostics / ``--mux-staleness`` guard
    read the spread.  Single-sync generations have one version
    throughout."""
    rid: int
    prompt: np.ndarray
    tokens: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    token_versions: list[int] = field(default_factory=list)
    finish_reason: str = ""              # "eos" | "length" ("stop" while
    #                                      suspended at a tool boundary)
    # trace timestamps (engine step counts and/or driver clock)
    prefill_step: int = -1
    finish_step: int = -1
    arrival_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # admission metadata copied from the Request (trace/report material)
    priority: int = 0
    deadline: Optional[float] = None
    job_id: Optional[str] = None
    prefix_shared_blocks: int = 0        # KV blocks admitted via radix sharing

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)
