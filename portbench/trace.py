"""What a traced run (``--trace 1``) records around the program, from the
benchmark's side of its entry points.

- Spans: the wall of each call into a layer of ``ttipm_tpu_torch.ipm``
  (the KKT assembly ``tt_infeasible_newton_system``, the KKT solve
  ``_solve_kkt``, the step sizes ``_tt_get_step_sizes``), synchronised
  with the device at its end, with its start and end on the host clock.
- Counters: calls of the ragged AMEn fallback (``tt_restarted_block_amen``);
  host synchronisations, from ``torch.cuda.set_sync_debug_mode("warn")``;
  for each of the six kernels, the roofline bound of every launch from its
  operands' shapes (``roofline.py``), taken at the entry points of
  ``ttipm_tpu_torch.ops.kernels``.
- The device's activities during the solve of one instance, the
  configuration's first (``device_trace``), from a kineto trace of the
  device alone, read from its raw events; the kernels' bounds are summed
  over the same solve.  A round's trace holds ~3 million activities, and
  stopping the profiler and reading them takes two minutes and a half; one
  instance's share keeps a traced run well inside its time limit.  The
  profiler is stopped without building its Python events.

Each wrapper is put in place on entering a ``Tracer`` and taken away on
leaving it.  Nothing here runs in an untraced run.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import roofline

__all__ = ["Tracer", "SPANS"]

# span name -> the function of ttipm_tpu_torch.ipm it wraps
SPANS = {
    "newton_system": "tt_infeasible_newton_system",
    "kkt_solve": "_solve_kkt",
    "step_size": "_tt_get_step_sizes",
}
FALLBACK = "tt_restarted_block_amen"


class Tracer:
    """Instruments one window.  ``spans`` gives each span's total seconds,
    ``counters`` the fallbacks and host syncs, ``bound_s`` the kernels'
    summed bounds; ``device_summary()`` reads the profiler's trace after the
    window."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans: Dict[str, float] = defaultdict(float)
        self.intervals: List[Tuple[int, int, str]] = []   # (start ns, end ns, span) host clock
        self.counters: Counter = Counter()
        self.bound_s: Dict[str, float] = defaultdict(float)
        self._saved = []
        self._prof = None
        self._results = None
        self._caught = None
        self._warn_ctx = None
        self._marker_ns = None

    # -- wrappers ---------------------------------------------------------
    def _span(self, name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.monotonic_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self._sync()
                t1 = time.monotonic_ns()
                self.spans[name] += (t1 - t0) / 1e9
                self.intervals.append((t0, t1, name))
        return wrapped

    def _count(self, name, fn):
        def wrapped(*args, **kwargs):
            self.counters[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def _kernel(self, entry, fn, stats):
        kernel = roofline.ENTRIES[entry]

        def wrapped(*args, **kwargs):
            before = stats[kernel].launches
            out = fn(*args, **kwargs)
            if self._results is None and self._prof is not None \
                    and stats[kernel].launches > before:
                self.bound_s[kernel] += roofline.bound_s(entry, args, kwargs)
            return out
        return wrapped

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _patch(self, module, name, wrapper):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, wrapper)

    def __enter__(self):
        from ttipm_tpu_torch import ipm
        from ttipm_tpu_torch.ops import kernels

        for span, fn in SPANS.items():
            self._patch(ipm, fn, self._span(span, getattr(ipm, fn)))
        self._patch(ipm, FALLBACK, self._count("fallbacks", getattr(ipm, FALLBACK)))
        for entry in roofline.ENTRIES:
            self._patch(kernels, entry, self._kernel(entry, getattr(kernels, entry),
                                                     kernels.STATS))
        if self.device.type == "cuda":
            self._warn_ctx = warnings.catch_warnings(record=True)
            self._caught = self._warn_ctx.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        self.counters["fallbacks"] = 0
        return self

    def __exit__(self, *exc):
        if self._warn_ctx is not None:
            torch.cuda.set_sync_debug_mode("default")
            self._warn_ctx.__exit__(*exc)
            self.counters["host_syncs"] = sum(
                1 for w in self._caught
                if "synchroniz" in str(w.message) and "portbench" not in str(w.filename))
            self._caught = None
        for module, name, original in reversed(self._saved):
            setattr(module, name, original)
        self._saved = []
        return False

    # -- the device's trace ------------------------------------------------
    @contextlib.contextmanager
    def device_trace(self):
        """Trace the device (on a card) over the block, once a run."""
        if self.device.type != "cuda" or self._prof is not None:
            yield
            return
        from torch.autograd.profiler import profile

        self._prof = profile(use_cpu=False, use_device="cuda", use_kineto=True)
        self._prof.__enter__()
        # a marker on the device ties the trace's clock to the host's
        self._sync()
        h0 = time.monotonic_ns()
        torch.ones(1, device=self.device).add_(1)
        self._sync()
        self._marker_ns = (h0 + time.monotonic_ns()) // 2
        try:
            yield
        finally:
            self._sync()
            self._results = torch.autograd._disable_profiler()
            stop = getattr(torch.autograd.profiler, "_run_on_profiler_stop", None)
            if stop is not None:
                stop()

    def device_summary(self, window: Tuple[int, int], solve_intervals: List[Tuple[int, int]]) -> dict:
        """Device time by kernel and in all, and idle time by what the host
        was doing, over ``window`` (host clock, ns: the traced solve).
        ``solve_intervals``: each solve's (start, end) on the host clock.
        None where the trace holds no device event (or no trace was taken:
        not on a card)."""
        if self._results is None:
            return None
        events = [e for e in self._results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()]
        if not events:
            return None
        starts = np.array([e.start_ns() for e in events], dtype=np.int64)
        ends = starts + np.array([e.duration_ns() for e in events], dtype=np.int64)
        names = [e.name() for e in events]
        # the first device event is the marker: shift the trace to the host clock
        shift = self._marker_ns - int(starts.min())
        starts, ends = starts + shift, ends + shift
        w0, w1 = window
        keep = (ends > w0) & (starts < w1)
        starts, ends = np.clip(starts[keep], w0, w1), np.clip(ends[keep], w0, w1)
        names = [n for n, k in zip(names, keep) if k]

        by_name, by_kernel = Counter(), Counter()
        for n, a, b in zip(names, starts, ends):
            by_name[n] += (b - a) / 1e9
        for n, seconds in by_name.items():
            kernel = roofline.kernel_of(n)
            if kernel is not None:
                by_kernel[kernel] += seconds

        order = np.argsort(starts, kind="stable")
        busy, gaps, end = 0, [], w0
        for i in order:
            a, b = int(starts[i]), int(ends[i])
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if end < w1:
            gaps.append((end, w1))

        idle = Counter()
        mids = np.array([(a + b) // 2 for a, b in gaps], dtype=np.int64)
        for label, seconds in zip(self._labels(mids, solve_intervals), gaps):
            idle[label] += (seconds[1] - seconds[0]) / 1e9
        return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
                "by_kernel_s": dict(by_kernel),
                "activities": len(names),
                "device_ops": [(n[:120], t) for n, t in by_name.most_common(10)],
                "idle_gaps": idle.most_common(10)}

    def _labels(self, times: np.ndarray, solve_intervals) -> List[str]:
        """What the host was doing at each of ``times``: the span around it
        (no two spans overlap), ``ipm_loop`` inside a solve but outside the
        spans, or ``between_solves``."""
        spans = sorted(self.intervals)
        span_at = _index_within(times, [(a, b) for a, b, _ in spans])
        solve_at = _index_within(times, sorted(solve_intervals))
        return [spans[i][2] if i >= 0 else ("ipm_loop" if j >= 0 else "between_solves")
                for i, j in zip(span_at, solve_at)]


def _index_within(times: np.ndarray, intervals) -> np.ndarray:
    """For each time, the index of the interval of the sorted, disjoint
    ``intervals`` that holds it, or -1."""
    if not intervals:
        return np.full(times.shape, -1)
    a = np.array([x[0] for x in intervals], dtype=np.int64)
    b = np.array([x[1] for x in intervals], dtype=np.int64)
    i = np.searchsorted(a, times, side="right") - 1
    return np.where((i >= 0) & (times < b[np.maximum(i, 0)]), i, -1)
