"""TT orthogonalisation and rounding.

A right-to-left QR sweep puts the train in right-orthogonal form, then a
left-to-right SVD sweep truncates each bond against a per-bond error budget
``eps / sqrt(d-1)``.  ``tt_psd_rank_reduce`` adds the discarded energy back
as a multiple of the identity so that a PSD input stays PSD.

Counterpart of ``ttipm_tpu/ops/rounding.py`` with the semantics of its
host (numpy) path.  The truncation rank is decided on the host from the
singular values of each bond, so every bond costs one device sync.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops.linalg import qr_econ, safe_svd
from ttipm_tpu_torch.ops.tt import TT, tt_add, tt_ranks

__all__ = [
    "prune_singular_vals", "pad_bond_factors", "tt_rl_orthogonalise",
    "tt_rank_reduce", "tt_psd_rank_reduce", "add_kick_rank",
]


def prune_singular_vals(s, eps: float) -> int:
    """Number of singular values to keep for a discarded tail energy
    < eps^2 (at least 1).  At eps=0 only an exactly-zero tail is dropped."""
    s = np.asarray(s.detach().cpu() if torch.is_tensor(s) else s)
    if np.linalg.norm(s) == 0.0:
        return 1
    tail = np.cumsum(np.abs(s[::-1]) ** 2)[::-1]
    budget = eps**2
    hits = np.nonzero(tail < budget if budget > 0 else tail <= 0.0)[0]
    r = int(hits[0]) if hits.size else int(s.size)
    return max(r, 1)


def _orthonormal_complement(q_mat: torch.Tensor, k: int) -> torch.Tensor:
    """k extra orthonormal columns orthogonal to the columns of q_mat.  The
    Gaussian draw comes from a fixed-seed numpy generator made anew per
    call, as in the JAX package, so padded solves are reproducible."""
    rng = np.random.default_rng(0xB04D)
    g = torch.as_tensor(rng.standard_normal((q_mat.shape[0], k)),
                        dtype=q_mat.dtype, device=q_mat.device)
    g = g - q_mat @ (q_mat.T @ g)
    q2, _ = qr_econ(g)
    return q2


def _pad_dim(x: torch.Tensor, dim: int, extra: int) -> torch.Tensor:
    """Zero-pad ``extra`` entries at the end of axis ``dim``."""
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def pad_bond_factors(left: torch.Tensor, right: torch.Tensor, r: int,
                     orth: str = "left"):
    """Pad a bond factor pair (left: (..., r), right: (r, ...)) to the rank
    bucket: the orthogonal factor gains an orthonormal complement, the
    other factor zeros, so the represented product is unchanged."""
    rb = config.bucket_rank(r)
    if orth == "left":
        m = int(np.prod(left.shape[:-1]))
    else:
        m = int(np.prod(right.shape[1:]))
    rb = min(rb, m)
    if rb <= r:
        return left, right, r
    k = rb - r
    if orth == "left":
        lmat = left.reshape(-1, r)
        lmat = torch.cat([lmat, _orthonormal_complement(lmat, k)], dim=1)
        left = lmat.reshape(*left.shape[:-1], rb)
        right = _pad_dim(right, 0, k)
    else:
        rmat = right.reshape(r, -1)
        comp = _orthonormal_complement(rmat.T, k).T
        right = torch.cat([rmat, comp], dim=0).reshape(rb, *right.shape[1:])
        left = _pad_dim(left, left.ndim - 1, k)
    return left, right, rb


def tt_rl_orthogonalise(train_tt: TT) -> TT:
    """Right-to-left QR sweep: all cores except the first become
    right-orthogonal."""
    out = list(train_tt)
    for i in range(len(out) - 1, 0, -1):
        core, prev = out[i], out[i - 1]
        r = core.shape[0]
        q, rm = qr_econ(core.reshape(r, -1).T)
        k = q.shape[1]
        out[i] = q.T.reshape((k,) + tuple(core.shape[1:]))
        out[i - 1] = (prev.reshape(-1, r) @ rm.T).reshape(
            tuple(prev.shape[:-1]) + (k,)
        )
    return out


def _truncation_sweep(train_tt: TT, eps: float,
                      compensation: Optional[str] = None):
    """Left-to-right SVD truncation of an RL-orthogonal train.  Returns the
    rounded train and the total discarded energy."""
    out = list(train_tt)
    discarded = 0.0
    for idx in range(len(out) - 1):
        shape = tuple(out[idx].shape)
        u, s, v_t = safe_svd(out[idx].reshape(-1, shape[-1]))
        s_host = s.cpu().numpy()
        next_rank = prune_singular_vals(s_host, eps)
        if compensation is not None and next_rank < s_host.size:
            tail = np.cumsum(np.abs(s_host[::-1]) ** 2)[::-1]
            discarded += float(tail[next_rank])
        padded = min(config.bucket_rank(next_rank), u.shape[0])
        u_k = u[:, :next_rank]
        nxt = out[idx + 1]
        folded = (s[:next_rank, None] * v_t[:next_rank, :]) @ nxt.reshape(
            nxt.shape[0], -1
        )
        if padded > next_rank:
            k = padded - next_rank
            u_k = torch.cat([u_k, _orthonormal_complement(u_k, k)], dim=1)
            folded = _pad_dim(folded, 0, k)
        out[idx + 1] = folded.reshape((padded,) + tuple(nxt.shape[1:]))
        out[idx] = u_k.reshape(shape[:-1] + (padded,))
    return out, discarded


def tt_rank_reduce(train_tt: TT, eps: float = 1e-18) -> TT:
    """Round a TT to the smallest ranks with total error <= eps."""
    eps = float(eps)
    dim = len(train_tt)
    ranks = [1] + tt_ranks(train_tt) + [1]
    if dim == 1 or all(r == 1 for r in ranks):
        return list(train_tt)
    bond_eps = eps / np.sqrt(dim - 1)
    out = tt_rl_orthogonalise(list(train_tt))
    out, _ = _truncation_sweep(out, bond_eps)
    return out


def _compensated_rank_reduce(train_tt: TT, eps: float):
    dim = len(train_tt)
    ranks = [1] + tt_ranks(train_tt) + [1]
    if dim == 1 or all(r == 1 for r in ranks):
        return list(train_tt), 0.0
    bond_eps = (eps / 2.0) / np.sqrt(dim - 1)
    out = tt_rl_orthogonalise(list(train_tt))
    out, discarded = _truncation_sweep(out, bond_eps, compensation="track")
    factor = float(discarded) ** (1.0 / (2 * dim)) if discarded > 0 else 0.0
    return out, factor


def tt_psd_rank_reduce(train_tt: TT, eps: float = 1e-18,
                       return_shift: bool = False):
    """PSD-preserving rounding: compensates the discarded energy with a
    multiple of the identity.  With ``return_shift`` also returns the
    magnitude of the identity shift added."""
    eps = float(eps)
    out, factor = _compensated_rank_reduce(train_tt, eps)
    shift = factor ** len(out)
    if not (len(out) == 1 and factor == 0.0):
        c0 = out[0]
        n = c0.shape[1]
        eye_core = factor * torch.eye(n, device=c0.device, dtype=c0.dtype).reshape(
            1, n, n, 1
        )
        out = tt_add(out, [eye_core] * len(out))
    if return_shift:
        return out, shift
    return out


def add_kick_rank(u: torch.Tensor, v: torch.Tensor, r_add: int = 2, rng=None):
    """Append ``r_add`` random directions to U and re-orthogonalise
    (rank-adaptive enrichment).  ``rng``: a numpy RandomState, default
    numpy's global one, drawn in the JAX package's order."""
    rng = np.random if rng is None else rng
    old_r = u.shape[1]
    kick = torch.as_tensor(rng.randn(u.shape[0], r_add), dtype=u.dtype,
                           device=u.device)
    q, r_mat = qr_econ(torch.cat((u, kick), dim=1))
    return q, r_mat[:, :old_r] @ v, int(q.shape[1])
