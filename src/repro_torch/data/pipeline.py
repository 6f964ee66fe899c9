"""Synthetic verifiable-reward (RLVR) task pipeline: integer arithmetic.

Copy of ``repro/data/pipeline.py`` (numpy only): with the same seed the
prompts, answers and texts are identical to the JAX package's.

Each prompt is ``"a+b="`` (or -, *); the verifiable answer is the decimal
result. This is the in-framework stand-in for DeepMath/Math-Orz-style RLVR
datasets; rewards are computed by exact-match verification in rl/rewards.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclass(frozen=True)
class TaskConfig:
    max_operand: int = 99
    ops: tuple[str, ...] = ("+", "-")
    prompt_len: int = 16
    max_answer_len: int = 8


@dataclass
class Batch:
    prompts: np.ndarray       # (B, prompt_len) int32, left-padded
    answers: list[str]        # verifiable ground truth
    prompt_text: list[str]


class ArithmeticTask:
    def __init__(self, cfg: TaskConfig = TaskConfig(), seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def sample_batch(self, batch_size: int) -> Batch:
        cfg = self.cfg
        a = self.rng.integers(0, cfg.max_operand + 1, batch_size)
        b = self.rng.integers(0, cfg.max_operand + 1, batch_size)
        op = self.rng.choice(list(cfg.ops), batch_size)
        texts, answers = [], []
        for ai, bi, oi in zip(a, b, op):
            texts.append(f"{ai}{oi}{bi}=")
            answers.append(str(ai + bi if oi == "+" else
                               ai - bi if oi == "-" else ai * bi))
        prompts = tok.pad_batch([tok.encode(t, bos=True) for t in texts],
                                cfg.prompt_len, left=True)
        return Batch(prompts, answers, texts)

    def iterate(self, batch_size: int) -> Iterator[Batch]:
        while True:
            yield self.sample_batch(batch_size)
