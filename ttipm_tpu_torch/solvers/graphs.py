"""CUDA graphs of the whole-solve programs' steps.

The JAX package compiles a whole fused solve into one program and runs
its sweep loop on the device (``lax.while_loop``).  The port's counterpart
is ``run``: a program hands it one step of fixed shapes (a sweep pair of
the fused AMEn, a half-sweep pair of an eigensolve, and each lead-in,
peeled and finishing sweep) and its operands, and on the card the step is
captured once per shape signature as a ``torch.cuda.CUDAGraph`` and
replayed from then on; the host reads the loop's test once a pair.  On CPU
tensors the step runs as it is (the plain version the tests hold against
the JAX programs).

* Signatures: the caller's static key (the step's name first, then d,
  caps, kick, ineq, tol, the direction), the numeric configuration
  that changes a step (``fingerprint``), and every operand's shape and dtype, with the
  operands' tree structure.
* Operands are copied into the graph's static input buffers before each
  replay, and its outputs cloned out after it (contiguous).  The eager
  runs on the card take contiguous copies too, so that a step run eagerly
  and its replay compute on the same layouts.
* All graphs share one memory pool; they never run concurrently, and a
  replay's outputs are cloned before the next replay.  A new signature's
  capture costs about two eager runs of its step; it pays only if the
  signature recurs (the KKT steps across a Newton solve's predictor and
  corrector and across iterations, the eigen steps across step-size
  solves).
* A new signature first runs its step eagerly on a side stream (the
  warmup, whose result is the call's), then is captured on that stream
  under ``torch.cuda.set_sync_debug_mode("error")``: a host read inside a
  body raises at capture.  A capture or replay that fails raises; nothing
  falls back.
* The one eager route on the card is the shape rule: a signature whose
  warmup sent a factorization outside the kernels' envelopes
  (``kernels.STATS[...].outside``, the Jacobi pipelines' shape-only rules
  of ``ops/jacobi.py``) runs its steps eagerly from then on, because
  ``torch.linalg.svd`` / ``eigh`` / ``qr`` check their results with a
  host sync and cannot be captured.  Such signatures are counted, and so
  are the steps they run.
* Launch accounting: the kernel wrappers count launches in Python, which a
  replay does not run.  The counts a capture made are taken back out of
  ``kernels.STATS`` (nothing ran) and added again on every replay, so
  ``STATS`` counts the launches the card made.
"""

from __future__ import annotations

import contextlib

import torch

from ttipm_tpu_torch import config, trace
from ttipm_tpu_torch.ops import jacobi, kernels

__all__ = ["GraphStats", "STATS", "run", "signature", "flatten", "unflatten", "fingerprint",
           "eager", "reset", "sends_eager"]


class GraphStats:
    """Captures, replays, the signatures the shape rule sent to eager runs
    (``eager_signatures``), the steps those ran (``eager_steps``), and the
    steps run eagerly on request (``forced_steps``, ``eager()``); each
    also by the step's name (the first item of its key: ``by_step``)."""

    FIELDS = ("captures", "replays", "eager_signatures", "eager_steps", "forced_steps")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)
        self.by_step = {}

    def add(self, step: str, field: str) -> None:
        setattr(self, field, getattr(self, field) + 1)
        counts = self.by_step.setdefault(step, dict.fromkeys(self.FIELDS, 0))
        counts[field] += 1

    def as_dict(self) -> dict:
        return {**{f: getattr(self, f) for f in self.FIELDS}, "by_step": self.by_step}


STATS = GraphStats()

_EAGER = "eager"        # a signature the shape rule sends to eager runs
_CACHE: dict = {}       # signature -> _Graph or _EAGER
_POOL = None
_STREAMS: dict = {}     # device -> side stream
_FORCE_EAGER = False


def reset() -> None:
    """Drop every captured graph and zero the counters."""
    global _POOL
    _CACHE.clear()
    _POOL = None
    STATS.reset()


@contextlib.contextmanager
def eager(flag: bool = True):
    """Within the block, steps on the card run eagerly (with the graphs'
    staging) instead of being captured or replayed: the comparison of a
    graphed program with the same program run eagerly."""
    global _FORCE_EAGER
    old, _FORCE_EAGER = _FORCE_EAGER, bool(flag)
    try:
        yield
    finally:
        _FORCE_EAGER = old


# ---------------------------------------------------------------------------
# Operand trees
# ---------------------------------------------------------------------------

def flatten(tree):
    """(the tensors of a nested dict / list / tuple in order, its
    structure); other leaves (ints, floats, None) are part of the
    structure."""
    leaves = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return "T"
        if isinstance(t, dict):
            keys = tuple(t)
            return ("d", keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return ("l" if isinstance(t, list) else "t", tuple(walk(v) for v in t))
        return ("c", t)

    return leaves, walk(tree)


def unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s == "T":
            return next(it)
        if s[0] == "d":
            return {k: build(v) for k, v in zip(s[1], s[2])}
        if s[0] in ("l", "t"):
            out = [build(v) for v in s[1]]
            return out if s[0] == "l" else tuple(out)
        return s[1]

    return build(spec)


def fingerprint():
    """The settings that change what a body computes at equal shapes."""
    return (str(config.dtype()), str(config.eigen_dtype()), config.mixed_local(),
            *jacobi.settings())


def signature(key, tree):
    """The graph cache's key of a call: the caller's static ``key``, the
    configuration's fingerprint, the tree's structure and each tensor's
    shape, dtype and device."""
    return _signature(key, *flatten(tree))


def _signature(key, leaves, spec):
    return (key, fingerprint(), spec,
            tuple((tuple(t.shape), t.dtype, str(t.device)) for t in leaves))


def sends_eager(delta) -> bool:
    """The shape rule: a step whose run (``delta``, a
    ``kernels.counts_delta``) sent any factorization outside the kernels'
    envelopes (to ``torch.linalg``, which syncs) is not captured."""
    return any(d["outside"] > 0 for d in delta.values())


# ---------------------------------------------------------------------------
# Capture and replay
# ---------------------------------------------------------------------------

class _Graph:
    def __init__(self, graph, static_in, static_out, out_spec, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.out_spec = out_spec
        self.launches = launches


def _contiguous_copies(leaves):
    return [t.clone(memory_format=torch.contiguous_format) for t in leaves]


def _stream(device):
    """The side stream of ``device`` that warmups and captures run on."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _pool():
    global _POOL
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    return _POOL


def _first(sig, fn, spec, leaves):
    """A new signature: the warmup (the call's result), then the shape
    rule, then the capture."""
    static_in = _contiguous_copies(leaves)
    device = leaves[0].device
    stream = _stream(device)
    main = torch.cuda.current_stream(device)
    stream.wait_stream(main)
    before = kernels.counts_snapshot()
    with torch.cuda.stream(stream):
        warm = fn(unflatten(spec, static_in))
    main.wait_stream(stream)
    warm_leaves, warm_spec = flatten(warm)
    result = unflatten(warm_spec, _contiguous_copies(warm_leaves))
    if sends_eager(kernels.counts_delta(before, kernels.counts_snapshot())):
        _CACHE[sig] = _EAGER
        STATS.add(sig[0][0], "eager_signatures")
        STATS.add(sig[0][0], "eager_steps")
        return result
    graph = torch.cuda.CUDAGraph()
    before = kernels.counts_snapshot()
    with torch.cuda.graph(graph, pool=_pool(), stream=stream):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(unflatten(spec, static_in))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    launches = kernels.counts_delta(before, kernels.counts_snapshot())
    kernels.add_counts(launches, -1)  # captured, not run
    out_leaves, out_spec = flatten(out)
    _CACHE[sig] = _Graph(graph, static_in, out_leaves, out_spec, launches)
    STATS.add(sig[0][0], "captures")
    return result


def run(key, fn, args):
    """``fn(args)``, a step of a whole-solve program whose operands
    ``args`` (a nested tree of tensors) have fixed shapes for a given
    ``key`` (a tuple, its first item the step's name); on the card
    replayed from a CUDA graph (captured at the signature's first call),
    on the CPU called as it is.  Returns the tree ``fn`` returns, as fresh
    tensors on the card."""
    leaves, spec = flatten(args)
    if not leaves or not leaves[0].is_cuda:
        return fn(args)
    sig = _signature(key, leaves, spec)
    entry = _CACHE.get(sig)
    if _FORCE_EAGER or entry is _EAGER:
        STATS.add(key[0], "forced_steps" if _FORCE_EAGER else "eager_steps")
        out = fn(unflatten(spec, _contiguous_copies(leaves)))
        out_leaves, out_spec = flatten(out)
        return unflatten(out_spec, _contiguous_copies(out_leaves))
    if entry is None:
        with trace.span("graph.capture", step=key[0]):
            return _first(sig, fn, spec, leaves)
    with trace.span("graph.replay", step=key[0]):
        torch._foreach_copy_(entry.static_in, leaves)
        entry.graph.replay()
        kernels.add_counts(entry.launches)
        STATS.add(key[0], "replays")
        return unflatten(entry.out_spec, _contiguous_copies(entry.static_out))
