"""Multi-turn agentic rollouts over the engine's suspend/resume lifecycle.

Counterpart of ``repro/rl/agentic.py``, copied whole (it is host code).

An *episode* alternates model turns with environment (tool) turns: the
model generates until it emits one of the environment's ``stop_tokens``
(a tool-call boundary), the engine **suspends** the request — its KV
blocks stay pinned under a
:class:`~repro_torch.serve.engine.SuspendedRequest`
handle while the slot goes back to the pool — the environment computes
the tool result, and the episode **resumes** with the result tokens
injected.  Long-tail tool latencies therefore cost *zero* slot time:
the slot serves other episodes while the tool runs.  That is the
ROADMAP's "biggest remaining bubble at long-tail episode lengths", and
:func:`run_episodes` measures it directly by also offering the
``hold_slots`` baseline — identical token mechanics, but an episode
waiting on its tool still counts against the slot pool (what an engine
without suspend support would do), so admission of new work stalls.

The driver takes any engine with the :class:`~repro_torch.serve.Engine`
suspend/resume surface (``submit``, ``step``, ``idle``, ``harvest``,
``harvest_suspended``, ``can_resume``, ``resume``) and is deterministic
under greedy decoding: per-episode token streams are independent of
batch composition, so ``hold_slots`` changes *when* things run, never
what is generated — the arms are token-identical by construction.

Time is virtual: one engine scheduler tick = one driver tick, and tool
latency is expressed in ticks (``tool_latency_ticks``), which keeps the
bench hermetic and the tests exact.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["Environment", "CountdownToolEnv", "Turn", "Episode",
           "run_episodes"]


class Environment:
    """Pluggable environment contract for multi-turn episodes.

    ``stop_tokens`` are the token ids that mark a tool-call boundary —
    they go on every generation request, so sampling one suspends the
    request instead of finishing it.  :meth:`react` is called once per
    suspension with the tokens of the turn just generated (including the
    trigger token) and decides what happens next:

    * ``(tool_tokens, False)`` — inject the tool result and keep going
      (the next turn may suspend again);
    * ``(tool_tokens, True)`` — inject and run the **final** turn: the
      resumed generation carries no stop tokens, so it ends the episode
      at EOS or budget exhaustion;
    * ``(None, _)`` — end the episode at this boundary (the environment
      is done with it).
    """
    stop_tokens: tuple = ()

    def react(self, episode: "Episode", turn_tokens: list[int]
              ) -> tuple[Optional[np.ndarray], bool]:
        raise NotImplementedError


class CountdownToolEnv(Environment):
    """Deterministic tool stub: allow ``turns`` tool calls per episode,
    each answered with ``tool_len`` tokens derived arithmetically from
    the turn's tokens (no RNG — byte-identical across runs and modes).
    Turn ``turns - 1`` is marked final, so the episode closes with a
    free-running generation."""

    def __init__(self, stop_tokens: tuple, *, vocab: int,
                 turns: int = 2, tool_len: int = 3):
        if turns < 1:
            raise ValueError("turns must be >= 1")
        self.stop_tokens = tuple(stop_tokens)
        self.vocab = vocab
        self.turns = turns
        self.tool_len = tool_len

    def react(self, episode, turn_tokens):
        t = len(episode.turns)              # 0-based index of this boundary
        if t >= self.turns:
            return None, True
        base = (int(np.sum(turn_tokens)) + 131 * t
                + 17 * episode.index) % self.vocab
        tool = np.asarray([(base + 7 * j) % self.vocab
                           for j in range(self.tool_len)], np.int32)
        return tool, t == self.turns - 1


@dataclass
class Turn:
    """One model turn plus the tool reply that followed it (empty for the
    final turn / an env-terminated boundary)."""
    tokens: list[int]
    logprobs: list[float]
    token_versions: list[int]
    tool_tokens: list[int] = field(default_factory=list)


@dataclass
class Episode:
    """One multi-turn episode: prompt, accumulated turns, and the virtual-
    tick accounting the bubble-reclaim bench reads."""
    index: int
    prompt: np.ndarray
    job_id: Optional[str] = None
    priority: int = 0
    turns: list[Turn] = field(default_factory=list)
    finish_reason: str = ""      # "eos" | "length" | "env_done"
    submit_tick: int = -1
    finish_tick: int = -1
    tool_wait_ticks: int = 0     # total ticks spent waiting on tools

    @property
    def gen_tokens(self) -> list[int]:
        """Model-generated tokens across all turns (no tool tokens)."""
        return [t for turn in self.turns for t in turn.tokens]

    @property
    def logprobs(self) -> list[float]:
        return [lp for turn in self.turns for lp in turn.logprobs]

    @property
    def token_versions(self) -> list[int]:
        return [v for turn in self.turns for v in turn.token_versions]

    @property
    def full_completion(self) -> list[int]:
        """The episode's full post-prompt sequence: model turns with the
        tool replies interleaved, in generation order."""
        out: list[int] = []
        for turn in self.turns:
            out.extend(turn.tokens)
            out.extend(turn.tool_tokens)
        return out

    @property
    def action_mask(self) -> list[int]:
        """1 for model-generated positions of :attr:`full_completion`,
        0 for injected tool tokens — only actions carry policy gradient."""
        out: list[int] = []
        for turn in self.turns:
            out.extend([1] * len(turn.tokens))
            out.extend([0] * len(turn.tool_tokens))
        return out


def _capacity(engine) -> int:
    cfg = engine.config
    return getattr(cfg, "num_slots", None) or cfg.decode_slots


def run_episodes(engine, env: Environment, prompts, *,
                 max_new_tokens: int, tool_latency_ticks: int = 0,
                 hold_slots: bool = False, job_id: Optional[str] = None,
                 priorities: Optional[list[int]] = None,
                 job_ids: Optional[list[Optional[str]]] = None,
                 max_ticks: Optional[int] = None):
    """Drive a batch of multi-turn episodes to completion.

    ``prompts`` is a list of 1-D int32 token arrays (heterogeneous
    lengths welcome); ``max_new_tokens`` is each episode's *total* model
    budget across turns.  ``tool_latency_ticks`` is how many engine
    ticks each tool call takes; ``hold_slots=True`` runs the baseline
    where a tool-waiting episode keeps its slot occupied (admission of
    new episodes is gated on ``live + waiting < capacity``), versus the
    default suspend mode where the slot is reclaimed for other work the
    moment the boundary token is sampled.

    ``job_ids``/``priorities`` tag each episode's requests for the
    engine's admission policy (deadline / SLO token budgets) — the
    tag-aware mixing path for heterogeneous agentic jobs; both default
    to uniform.  Returns ``(episodes, stats)`` where ``stats["ticks"]``
    is the virtual makespan the bench compares across modes.
    """
    from repro_torch.serve import Request

    n = len(prompts)
    if priorities is None:
        priorities = [0] * n
    if job_ids is None:
        job_ids = [job_id] * n
    episodes = [Episode(index=i, prompt=np.asarray(p, np.int32),
                        job_id=job_ids[i], priority=priorities[i])
                for i, p in enumerate(prompts)]
    capacity = _capacity(engine)
    limit = max_ticks if max_ticks is not None else \
        200 * n * (max_new_tokens + 1) * (tool_latency_ticks + 1)

    next_rid = [0]

    def fresh_rid() -> int:
        next_rid[0] += 1
        return next_rid[0] - 1

    by_rid: dict[int, Episode] = {}       # rid of the *current* turn -> ep
    to_submit = deque(episodes)           # episodes awaiting their 1st turn
    waiting: list[list] = []              # [due_tick, ep, sreq, tool, last]
    ready = deque()                       # resumable: (ep, sreq, tool, last)
    done = 0
    tick = 0
    stats = {"mode": "hold" if hold_slots else "suspend",
             "episodes": n, "turns": 0, "tool_calls": 0,
             "tool_wait_ticks": 0, "ticks": 0}

    def remaining(ep: Episode) -> int:
        return max_new_tokens - len(ep.gen_tokens)

    def record_turn(ep: Episode, out) -> None:
        ep.turns.append(Turn(tokens=list(out.tokens),
                             logprobs=list(out.logprobs),
                             token_versions=list(out.token_versions)))
        stats["turns"] += 1

    def finish(ep: Episode, reason: str) -> None:
        nonlocal done
        ep.finish_reason = reason
        ep.finish_tick = tick
        done += 1

    def in_flight() -> int:
        """Episodes currently consuming (hold mode: or holding) a slot."""
        return len(by_rid) + len(waiting) + len(ready)

    while done < n:
        if tick >= limit:
            raise RuntimeError(
                f"agentic driver exceeded {limit} ticks with "
                f"{n - done}/{n} episodes unfinished — check stop_tokens/"
                f"budget sizing")
        # tool results whose latency elapsed become resumable
        still = []
        for w in waiting:
            if tick >= w[0]:
                ready.append(tuple(w[1:]))
            else:
                still.append(w)
        waiting[:] = still
        # resume before admitting new work: in hold mode the resume
        # reclaims the episode's own held slot, in suspend mode it
        # competes for free slots like any admission
        n_ready = len(ready)
        for _ in range(n_ready):
            ep, sreq, tool, last = ready[0]
            budget = remaining(ep)
            if budget <= 0:
                ready.popleft()
                sreq.release()
                finish(ep, "length")
                continue
            if not engine.can_resume(sreq, tool, max_new_tokens=budget):
                break
            ready.popleft()
            rid = fresh_rid()
            engine.resume(sreq, tool, max_new_tokens=budget, rid=rid,
                          stop_tokens=(() if last else None))
            by_rid[rid] = ep
        # first-turn submissions (hold mode: gated on held capacity)
        while to_submit:
            if hold_slots and in_flight() >= capacity:
                break
            ep = to_submit[0]
            req = Request(rid=fresh_rid(), prompt=ep.prompt,
                          max_new_tokens=max_new_tokens,
                          stop_tokens=env.stop_tokens, job_id=ep.job_id,
                          priority=ep.priority)
            if not engine.submit(req):
                break                     # queue backpressure
            to_submit.popleft()
            ep.submit_tick = tick
            by_rid[req.rid] = ep
        if not engine.idle:
            engine.step()
        tick += 1
        # tool boundaries: ask the environment what happens next
        for sreq in engine.harvest_suspended():
            ep = by_rid.pop(sreq.req.rid)
            record_turn(ep, sreq.out)
            tool, last = env.react(ep, list(sreq.out.tokens))
            if tool is None:
                sreq.release()
                finish(ep, "env_done")
                continue
            stats["tool_calls"] += 1
            ep.turns[-1].tool_tokens = [int(t) for t in np.asarray(tool)]
            ep.tool_wait_ticks += tool_latency_ticks
            stats["tool_wait_ticks"] += tool_latency_ticks
            waiting.append([tick + tool_latency_ticks, ep, sreq,
                            np.asarray(tool, np.int32), last])
        # finished turns (EOS / budget): the episode is over
        for out in engine.harvest():
            ep = by_rid.pop(out.rid)
            record_turn(ep, out)
            finish(ep, out.finish_reason)
    stats["ticks"] = tick
    radix = getattr(engine, "radix", None)
    if radix is not None:
        # resumed histories register in the content-addressed tree, so
        # sibling episodes (and turn k+1) share turn k's prompt blocks —
        # surface the hit/saving counters alongside the episode stats
        stats["radix"] = dict(radix.stats)
    return episodes, stats
