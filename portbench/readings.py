"""What the metric readers (``metrics/<name>.py``) share: sums over the
solves of a run.  A run is the dict that ``run.py`` hands every reader:
``solves`` (``program.Solve``), ``setup_s``, ``window_s``, ``launches``
(the six kernels' launches in the window) and, in a traced run, ``spans``
(seconds by span), ``counters`` (``fallbacks``, ``host_syncs``),
``bound_s`` (the kernels' summed roofline bounds in the traced solve)
and ``device`` (the traced solve's busy and window seconds, device
seconds by kernel; ``None`` where the trace held nothing)."""

from __future__ import annotations

__all__ = ["wall_s", "iters", "span_pct", "roofline_pct"]


def wall_s(run) -> float:
    """Summed walls of every solve of the window."""
    return sum(s.wall_s for s in run["solves"])


def iters(run) -> int:
    """Summed iterations of the solves that returned."""
    return sum(s.iters for s in run["solves"] if s.error is None)


def span_pct(run, span: str):
    """A span's seconds as a share of the solves' walls, in percent; None
    outside a traced run."""
    if span not in run["spans"] or not run["solves"]:
        return None
    return 100.0 * run["spans"][span] / wall_s(run)


def roofline_pct(run, kernel: str):
    """The kernel's summed roofline bounds over its device time, in
    percent; None where the trace shows no launch of it."""
    device = run["device"]
    if not device or not device["by_kernel_s"].get(kernel) or not run["bound_s"].get(kernel):
        return None
    return 100.0 * run["bound_s"][kernel] / device["by_kernel_s"][kernel]
