"""Randomised TT tools: sketching, randomised orthogonalisation and the
generalised Nystrom rank reduction.

Counterpart of ``ttipm_tpu/ops/randomized.py``
(reference src/tt_ops.py:51-101, 232-300).  These support
rank-adaptive experimentation around the solver (the solve path itself
uses deterministic roundings).  Every Gaussian is drawn by numpy, from
the RandomState ``rng`` (default numpy's global one) in the JAX package's
order, so one seed gives the JAX package's sketch; the cores go to the
device and dtype of the train they sketch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ttipm_tpu_torch.ops.linalg import safe_svd
from ttipm_tpu_torch.ops.random import tt_random_gaussian
from ttipm_tpu_torch.ops.tt import TT, tt_swap_all

__all__ = [
    "tt_rl_contraction",
    "tt_lr_contraction",
    "tt_lr_random_orthogonalise",
    "tt_rl_random_orthogonalise",
    "tt_generalised_nystroem",
    "tt_sketch",
    "tt_sketch_like",
]


def tt_rl_contraction(train_1_tt: TT, train_2_tt: TT) -> List[torch.Tensor]:
    """Right-to-left partial contractions of two trains
    (src/tt_ops.py:51-58)."""
    new_cores = [
        train_1_tt[-1].reshape(train_1_tt[-1].shape[0], -1)
        @ train_2_tt[-1].reshape(train_2_tt[-1].shape[0], -1).T
    ]
    for core_1, core_2 in zip(train_1_tt[-2:0:-1], train_2_tt[-2:0:-1]):
        core_w = new_cores[-1]
        core_z = core_1.reshape(-1, core_w.shape[0]) @ core_w
        new_cores.append(core_z.reshape(core_1.shape[0], -1)
                         @ core_2.reshape(core_2.shape[0], -1).T)
    return new_cores[::-1]


def tt_lr_contraction(train_1_tt: TT, train_2_tt: TT) -> List[torch.Tensor]:
    swapped = tt_rl_contraction(tt_swap_all(train_1_tt), tt_swap_all(train_2_tt))
    return [c.transpose(0, -1) for c in reversed(swapped)]


def tt_sketch(shape, target_ranks: List[int], *, device, dtype=torch.float64,
              rng=None) -> TT:
    """Gaussian sketch train of given ranks (src/tt_ops.py:240-244)."""
    rng = np.random if rng is None else rng
    size = int(np.prod(shape))
    return [torch.as_tensor(rng.randn(l_n, *shape, l_np1) / (l_n * size * l_np1),
                            dtype=dtype, device=device)
            for l_n, l_np1 in zip(target_ranks[:-1], target_ranks[1:])]


def tt_sketch_like(train_tt: TT, target_ranks: List[int], rng=None) -> TT:
    """Sketch with the physical shapes of an existing train
    (src/tt_ops.py:232-237), on its device and in its dtype."""
    rng = np.random if rng is None else rng
    ref = train_tt[0]
    out = []
    for i, (l_n, l_np1) in enumerate(zip(target_ranks[:-1], target_ranks[1:])):
        shape = tuple(train_tt[i].shape[1:-1])
        out.append(torch.as_tensor(
            rng.randn(l_n, *shape, l_np1) / (l_n * int(np.prod(shape)) * l_np1),
            dtype=ref.dtype, device=ref.device))
    return out


def _lr_random_orthogonalise(train_tt: TT, gaussian_tt: TT) -> TT:
    """Sketched left-to-right orthogonalisation (src/tt_ops.py:89-101)."""
    out = list(train_tt)
    contractions = tt_rl_contraction(out, gaussian_tt)
    for i, core_w in enumerate(contractions):
        shape_i1 = out[i + 1].shape
        core_z = out[i].reshape(-1, shape_i1[0])
        q, _ = torch.linalg.qr(core_z @ core_w, mode="reduced")
        out[i] = q.reshape(*out[i].shape[:-1], -1)
        out[i + 1] = ((q.T @ core_z) @ out[i + 1].reshape(shape_i1[0], -1)).reshape(
            -1, *shape_i1[1:])
    return out


def _gaussian(train_tt: TT, target_ranks, rng):
    ref = train_tt[0]
    return tt_random_gaussian(target_ranks, tuple(ref.shape[1:-1]), device=ref.device,
                              dtype=ref.dtype, rng=rng)


def tt_lr_random_orthogonalise(train_tt: TT, target_ranks: List[int], rng=None) -> TT:
    """Randomised LR orthogonalisation to target ranks
    (src/tt_ops.py:68-72)."""
    if len(train_tt) <= 1:
        return list(train_tt)
    return _lr_random_orthogonalise(list(train_tt), _gaussian(train_tt, target_ranks, rng))


def tt_rl_random_orthogonalise(train_tt: TT, target_ranks: List[int], rng=None) -> TT:
    """Randomised RL orthogonalisation (src/tt_ops.py:75-80)."""
    if len(train_tt) <= 1:
        return list(train_tt)
    gaussian = tt_swap_all(_gaussian(train_tt, target_ranks, rng))
    return tt_swap_all(_lr_random_orthogonalise(tt_swap_all(train_tt), gaussian))


def tt_generalised_nystroem(train_tt: TT, target_ranks: List[int], rng=None) -> TT:
    """Two-sided sketched (generalised Nystrom) rank reduction
    (src/tt_ops.py:273-300)."""
    if len(train_tt) <= 1:
        return list(train_tt)
    out = list(train_tt)
    g1 = _gaussian(out, target_ranks, rng)
    g2 = _gaussian(out, [r + 1 for r in target_ranks], rng)
    lr = tt_lr_contraction(out, g1)
    rl = tt_rl_contraction(out, g2)
    Ls, Rs = [], []
    for W_L, W_R in zip(lr, rl):
        u, s, v_t = safe_svd(W_L @ W_R)
        root_s_inv = torch.diag(1.0 / torch.sqrt(s))
        Ls.append(W_R @ v_t.T @ root_s_inv)
        Rs.append(root_s_inv @ u.T @ W_L)
    out[0] = (out[0].reshape(-1, out[0].shape[-1]) @ Ls[0]).reshape(*out[0].shape[:-1], -1)
    for i in range(1, len(out) - 1):
        folded = (out[i].reshape(-1, out[i].shape[-1]) @ Ls[i]).reshape(out[i].shape[0], -1)
        out[i] = (Rs[i - 1] @ folded).reshape(out[i - 1].shape[-1], *out[i].shape[1:-1], -1)
    out[-1] = (Rs[-1] @ out[-1].reshape(out[-1].shape[0], -1)).reshape(-1, *out[-1].shape[1:])
    return out
