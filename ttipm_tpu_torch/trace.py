"""Spans and counters of the solver's layers, and host syncs by span; off
unless a caller turns them on.

    from ttipm_tpu_torch import trace
    trace.enable(syncs=True)
    X, Y, T, Z, info = ipm.tt_ipm(...)
    record = trace.take()    # {"spans": [...], "counters": {...}, "syncs_by_line": {...}}
    trace.disable()

Off (the default), ``span`` returns one shared no-op context manager after
a single test of a module global, and ``count`` returns at once: no
allocation, no clock read, no torch call, no device sync.

On, every span records its name, the index of its parent (the span open
around it, -1 for none), the id of the solve it belongs to (each
``ipm.tt_ipm`` call opens the root span ``ipm.solve`` with a fresh id;
spans outside a solve have 0), its start and end from
``time.monotonic_ns()`` and a few attributes.  The clock is the host's;
nothing here synchronises with the device, so where the solver is paced
by its host (the device idles most of a solve) a span's length is the
time the host spent in that layer.  Spans and counters are kept in
memory until ``take()``.  A span opened while a CUDA graph is being
captured records nothing (the capture's host time is not the replay's),
and neither does a counter.

``enable(syncs=True)`` also counts host synchronisations: it sets
``torch.cuda.set_sync_debug_mode("warn")``, and each sync warning raised
while a span is open is counted against the innermost open span (a
span's ``syncs`` are its own, its children's not included); every sync
warning is also counted by the file and line that raised it
(``syncs_by_line``).  Each warning is passed on to the handler that was
installed before, so another counter of the same warnings (a
``catch_warnings(record=True)`` log) sees all of them; Python's default
printer gets a line's first only, as it would without the trace.

The names of the spans and counters, and where each is recorded:

* ``ipm.solve`` (root, one a ``tt_ipm`` call), ``ipm.iteration``
  (``iteration``), ``ipm.newton_system``, ``ipm.kkt_solve`` (``role``:
  predictor or corrector), ``ipm.step_size``, ``ipm.corrector_rhs``,
  ``ipm.update`` (the iterates' update) in ``ipm.py``;
* ``kkt.prep``, ``kkt.rung`` (``R``), ``kkt.refine``, ``kkt.residual``,
  counter ``kkt.ladder_exhausted`` in ``solvers/fused.py``; ``kkt.sweep``
  (with the host read of its residuals; on the whole-solve path a sweep
  or sweep pair of the graphed program), counter ``kkt.sweeps`` (each
  sweep), ``kkt.local_solve``, ``kkt.split`` in ``solvers/fused_batch.py``
  and ``solvers/fused.py``; ``kkt.warm_round`` (the warm start's
  rounding) and ``kkt.fallback`` (the ragged AMEn after the ladder) in
  ``ipm.py``;
* ``eigen.solve`` (``kind``: gen or min), ``eigen.sweep``, counter
  ``eigen.sweeps`` (each half sweep of windows) in
  ``solvers/fused_eigen.py`` and ``solvers/fused_eigen_batch.py``;
* ``graph.capture`` (a step's first call: its eager run and its
  capture), ``graph.replay`` in ``solvers/graphs.py``;
* ``setup.kernel_load`` (building and loading the kernels' library) in
  ``ops/_build.py``.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import Counter
from typing import List, Optional

__all__ = ["enable", "disable", "enabled", "span", "solve", "count", "take", "self_ns",
           "inclusive_syncs"]

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SYNC_MESSAGE = "called a synchronizing CUDA operation"

_clock = time.monotonic_ns
_rec: Optional["_Recorder"] = None   # None: tracing is off


class _Noop:
    """The span of tracing off, shared by every call."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "index", "name", "attrs", "parent", "solve", "start_ns", "end_ns",
                 "syncs")

    def __init__(self, rec, name, attrs, solve_id=None):
        self.rec = rec
        self.name = name
        self.attrs = attrs
        self.solve = solve_id
        self.end_ns = None
        self.syncs = 0

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        self.parent = -1 if parent is None else parent.index
        if self.solve is None:
            self.solve = 0 if parent is None else parent.solve
        self.index = len(rec.spans)
        rec.spans.append(self)
        rec.stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        stack = self.rec.stack
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "solve": self.solve,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": self.attrs,
                "syncs": self.syncs}


class _Recorder:
    """What one ``enable()`` records until ``take()``."""

    def __init__(self, syncs: bool):
        self.syncs = syncs
        self.spans: List[_Span] = []
        self.stack: List[_Span] = []   # the open spans, innermost last
        self.counters: Counter = Counter()
        self.sync_lines: Counter = Counter()
        self.solves = 0
        self.capturing = None          # torch's capture test, where there is a card
        self.sync_mode = None          # the sync debug mode before enable()

    def live(self) -> bool:
        """Not inside a CUDA-graph capture."""
        return self.capturing is None or not self.capturing()

    def on_sync(self, filename: str, lineno: int) -> None:
        if self.stack:
            self.stack[-1].syncs += 1
        path = os.path.abspath(filename)
        if path.startswith(_PKG_PARENT + os.sep):
            path = os.path.relpath(path, _PKG_PARENT)
        self.sync_lines[f"{path}:{lineno}"] += 1


def enabled() -> bool:
    return _rec is not None


def enable(syncs: bool = False) -> None:
    """Turn the record on (a fresh one); ``syncs``: count host syncs by span
    too (``torch.cuda.set_sync_debug_mode("warn")`` where there is a card)."""
    global _rec
    disable()
    import torch

    rec = _Recorder(syncs)
    if torch.cuda.is_available():
        rec.capturing = torch.cuda.is_current_stream_capturing
        if syncs:
            rec.sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
    _rec = rec
    if syncs:
        _install_sync_hook()


def disable() -> None:
    """Turn the record off; what was not taken is dropped."""
    global _rec
    rec, _rec = _rec, None
    if rec is None or not rec.syncs:
        return
    if rec.sync_mode is not None:
        import torch

        torch.cuda.set_sync_debug_mode(rec.sync_mode)
    hook = warnings.showwarning
    if getattr(hook, "_ttipm_trace", False):
        warnings.showwarning = hook._ttipm_previous
    warnings.filters[:] = [f for f in warnings.filters if not _is_sync_filter(f)]
    getattr(warnings, "_filters_mutated", lambda: None)()


def span(name: str, **attrs):
    """A context manager that records the block as span ``name``."""
    rec = _rec
    if rec is None or not rec.live():
        return _NOOP
    return _Span(rec, name, attrs)


def solve(**attrs):
    """The root span ``ipm.solve`` of one solve, with a fresh solve id."""
    rec = _rec
    if rec is None or not rec.live():
        return _NOOP
    if rec.syncs:
        _install_sync_hook()
    rec.solves += 1
    return _Span(rec, "ipm.solve", attrs, rec.solves)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    rec = _rec
    if rec is not None and rec.live():
        rec.counters[name] += n


def take() -> dict:
    """The spans (dicts, in the order they were opened; ``parent`` indexes
    this list), the counters and the syncs by file and line recorded since
    the last ``take()``, which are then cleared.  Call it with no span
    open.  Empty where tracing is off."""
    rec = _rec
    if rec is None:
        return {"spans": [], "counters": {}, "syncs_by_line": {}}
    out = {"spans": [s.as_dict() for s in rec.spans], "counters": dict(rec.counters),
           "syncs_by_line": dict(rec.sync_lines)}
    rec.spans, rec.stack = [], []
    rec.counters, rec.sync_lines = Counter(), Counter()
    return out


def self_ns(spans: List[dict]) -> List[int]:
    """Each span's self time: its length less its children's."""
    out = [s["end_ns"] - s["start_ns"] for s in spans]
    for s in spans:
        if s["parent"] >= 0:
            out[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return out


def inclusive_syncs(spans: List[dict]) -> List[int]:
    """Each span's host syncs, its descendants' included."""
    out = [s["syncs"] for s in spans]
    for i in range(len(spans) - 1, -1, -1):   # children come after their parent
        if spans[i]["parent"] >= 0:
            out[spans[i]["parent"]] += out[i]
    return out


# ---------------------------------------------------------------------------
# The sync hook
# ---------------------------------------------------------------------------

def _is_sync_filter(f) -> bool:
    return f[0] == "always" and f[1] is not None and f[1].pattern == _SYNC_MESSAGE


def _printing(handler) -> bool:
    """``handler`` is Python's default ``showwarning``, printing to stderr
    (not a ``catch_warnings(record=True)`` log, nor another handler)."""
    impl = warnings._showwarnmsg_impl
    return (handler is warnings._showwarning_orig
            and getattr(impl, "__module__", None) == "warnings"
            and impl.__name__ == "_showwarnmsg_impl")


def _install_sync_hook() -> None:
    """Put the counting hook in front of the current ``warnings.showwarning``
    and show every sync warning (not once a line), unless both are in
    place.  Run again at each solve's start: a ``catch_warnings`` block
    entered since replaces the hook."""
    if not any(_is_sync_filter(f) for f in warnings.filters):
        warnings.filterwarnings("always", message=_SYNC_MESSAGE)
    previous = warnings.showwarning
    if getattr(previous, "_ttipm_trace", False):
        return

    shown = set()

    def hook(message, category, filename, lineno, file=None, line=None):
        rec = _rec
        if rec is not None and rec.syncs and str(message).startswith(_SYNC_MESSAGE):
            rec.on_sync(filename, lineno)
            if _printing(previous):
                # Python's own printer shows a line's warning once, as the
                # default filter would without the trace's "always"
                if (filename, lineno) in shown:
                    return
                shown.add((filename, lineno))
        previous(message, category, filename, lineno, file, line)

    hook._ttipm_trace = True
    hook._ttipm_previous = previous
    warnings.showwarning = hook
