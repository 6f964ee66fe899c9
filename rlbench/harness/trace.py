"""The device trace of a traced run (``--trace 1``).

``torch.profiler`` records the device's kernels and copies, and the CUDA
runtime calls the host made, over a span the driver opens and closes
(:meth:`Tracer.start`, :meth:`Tracer.stop`).  :meth:`Tracer.summary`
reduces them to the seconds in which some operation ran on the device (the
union of their intervals: two streams may run at once), the span's
length, device seconds by kernel name, and the longest idle gaps, each
named by the host spans (the driver's phases) that were open during it.
The profiler's clock is the system clock (``time.time_ns``); host spans
taken with ``time.perf_counter`` are moved onto it by the offset between
the two clocks, read when the trace starts.
"""
from __future__ import annotations

import threading
import time

import torch

from rlbench.harness.stats import idle_gaps, merged


def perf_to_ns_offset() -> int:
    """``time.time_ns() - perf_counter_ns()``, the smaller of a few reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


class Tracer:
    """One profiled span of a run.

    The profiler belongs to the thread that starts it, and the executors'
    phases run on threads of their own, so a worker thread of the tracer
    starts and stops it.  The worker opens and closes one empty session
    when the tracer is made (in set-up), so that the profiler's own
    start-up stays out of the window.  :meth:`start` opens the span and
    :meth:`end` closes it (both from any thread, once each; ``end`` waits
    for the device); :meth:`stop`, called once the window has closed,
    stops the profiler, whose collection of the events takes long."""

    def __init__(self, device_type: str = "cuda"):
        # the CPU case exercises the reduction in the CPU tests only: there
        # the "device" events are the host's aten ops
        self.cuda = device_type == "cuda"
        self.prof = None                  # the session's result, once stopped
        self.t0 = self.t1 = None          # the span, perf_counter seconds
        self.offset_ns = perf_to_ns_offset()
        self._go = [threading.Event() for _ in range(2)]
        self._done = [threading.Event() for _ in range(3)]
        self._error = None
        self._worker = threading.Thread(target=self._work, daemon=True,
                                        name="rlbench-tracer")
        self._worker.start()
        self._wait(0)

    def _begin(self):
        """Start a profiling session on this thread.  The autograd
        profiler's own entry points, not ``torch.profiler.profile``, whose
        stop turns every event into a Python object (minutes for a span of
        decode ticks); :meth:`summary` reads the raw events instead."""
        from torch.autograd import (ProfilerActivity, _enable_profiler,
                                    _prepare_profiler)
        from torch.autograd import profiler
        acts = {ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU}
        cfg = profiler.profile(use_kineto=True, use_device=(
            "cuda" if self.cuda else None)).config()
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)

    def _work(self):
        from torch.autograd import _disable_profiler
        try:
            self._begin()
            if self.cuda:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            _disable_profiler()
        except Exception as e:          # raised by the caller's wait
            self._error = e
        self._done[0].set()
        self._go[0].wait()
        try:
            if self._error is None:
                self._begin()
                self.prof = True
                self.t0 = time.perf_counter()
        except Exception as e:
            self._error = e
        self._done[1].set()
        self._go[1].wait()
        try:
            if self.prof:
                self.prof = _disable_profiler()
        except Exception as e:
            self._error = e
        self._done[2].set()

    def _wait(self, i: int):
        self._done[i].wait()
        if self._error is not None:
            raise RuntimeError("the profiler failed") from self._error

    @property
    def active(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def start(self):
        self._go[0].set()
        self._wait(1)

    def end(self):
        if self._go[0].is_set():
            self._wait(1)           # a start the worker may still be making
        if self.t0 is None or self.t1 is not None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()

    def stop(self):
        """Stop the profiler (and the worker); a span never opened stays
        empty."""
        self._go[0].set()
        self._go[1].set()
        self._worker.join()
        if self._error is not None:
            raise RuntimeError("the profiler failed") from self._error

    def summary(self, host_spans=(), top: int = 10) -> dict:
        """``{busy_s, window_s, kernel_s: {name: s}, top_ops, idle_gaps}``
        of the span; ``host_spans`` ``[(label, t0, t1)]`` in perf_counter
        seconds name the idle gaps."""
        if not self.prof or self.t1 is None or self._worker.is_alive():
            raise RuntimeError("the trace was never taken, or not stopped")
        lo = int(self.t0 * 1e9) + self.offset_ns
        hi = int(self.t1 * 1e9) + self.offset_ns
        ivs, by_name = [], {}
        want = (torch.autograd.DeviceType.CUDA if self.cuda
                else torch.autograd.DeviceType.CPU)
        for e in self.prof.events():
            if e.device_type() != want:
                continue
            s, d = e.start_ns(), e.duration_ns()
            a, b = max(s, lo), min(s + d, hi)
            if b <= a:
                continue
            ivs.append((a, b))
            name = e.name()
            by_name[name] = by_name.get(name, 0) + (b - a)
        busy = merged(ivs)
        busy_ns = sum(b - a for a, b in busy)
        spans = [(lab, int(t0 * 1e9) + self.offset_ns,
                  int(t1 * 1e9) + self.offset_ns)
                 for lab, t0, t1 in host_spans]
        gaps = []
        for g0, g1 in idle_gaps(busy, lo, hi)[:top]:
            open_ = sorted({lab for lab, s0, s1 in spans
                            if s0 < g1 and s1 > g0}) or ["no phase"]
            gaps.append(["+".join(open_), (g1 - g0) / 1e9])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9,
                "events": len(ivs),
                "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
                "top_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": gaps}


def kernel_seconds(kernel_s: dict, names) -> float:
    """Device seconds of the kernels whose names contain one of ``names``
    (the profiler gives demangled signatures)."""
    return sum(s for k, s in kernel_s.items() if any(n in k for n in names))
