"""The port's Jacobi SVD and eigh (ttipm_tpu_torch/ops/jacobi.py) against the
JAX package's (ttipm_tpu/ops/jacobi.py, forced on the CPU as
tests/test_jacobi.py forces it), on the CPU, where the port runs the
plain versions of its kernels J1 and J2.

Inputs are made with numpy from a seed and handed to both.  Tolerances:
singular values and eigenvalues within 1e-12 of the JAX package's,
relative to the largest; reconstruction and orthonormality within 1e-13
(max-abs, relative to max |a|), and for eigh above order 64 within n / 64
times that: the eigenvectors are a product of about sweeps x n rotations
each, whose rounding grows with the order past 1e-13 at 256; singular
vectors and eigenvectors within
1e-10 of the JAX package's up to sign where the gap to the neighbouring
values exceeds 1e-8 relative to the largest, and where that gap leaves
room for two backward-stable factorizations to agree there (their vectors
differ by about their backward errors over the gap, a few 1e-15 of the
largest value over 1e-5).  The dispatch: CPU tensors keep
``torch.linalg``'s bits unless ``forced(True)``.  The slice: maxcut d3
seed 319 through the port with every SVD and eigh on the plain Jacobi
against the JAX package's solve.  J1 and J2 are each held in the regime the
shipped crossover gives an order and, from the order from which the block
regime is tested (24), also in the block regime (orthogonalise_block_plain,
eigh_block_plain).
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

from ttipm_tpu.ops import jacobi as jj
from ttipm_tpu_torch.ops import jacobi as tj
from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.ops import linalg


# The block regimes (J1 and J2) are held from the order from which J2's was
# measured faster than its element kernel on the card (PERF.md), beside the
# regime each order takes under the crossovers the port ships
# (kernels.J1_BLOCK_FROM, kernels.J2_BLOCK_FROM).
BLOCK_TESTED_FROM = 24


@contextmanager
def _block_from(n, core="j2"):
    """J2's (or J1's) regimes with the block regime from order n."""
    name, plan = {"j2": ("J2_BLOCK_FROM", K.j2_plan), "j1": ("J1_BLOCK_FROM", K.j1_plan)}[core]
    saved = getattr(K, name)
    setattr(K, name, n)
    plan.cache_clear()
    try:
        yield
    finally:
        setattr(K, name, saved)
        plan.cache_clear()


def _crossovers(n, core="j2"):
    """The crossovers under which order n takes each regime it is tested
    in: the shipped one, and BLOCK_TESTED_FROM where that moves n into the
    block regime."""
    n += n % 2
    shipped = K.J2_BLOCK_FROM if core == "j2" else K.J1_BLOCK_FROM
    return [shipped] + ([BLOCK_TESTED_FROM] if BLOCK_TESTED_FROM <= n < shipped else [])


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain Jacobi is thousands of tiny torch ops: on one thread a
    worker does not spin against its neighbours in a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_jacobi():
    jj.force_jacobi(True)
    yield
    jj.force_jacobi(None)


def _gallery():
    """tests/test_jacobi.py's gallery."""
    rng = np.random.RandomState(0)
    n = 24
    q1, _ = np.linalg.qr(rng.randn(n, n))
    q2, _ = np.linalg.qr(rng.randn(n, n))
    A = (q1 * np.logspace(0, -6, n)) @ q2.T
    Z = A.copy(); Z[:, 20:] = 0.0
    T = A.copy(); T[:, 20:] *= 1e-15
    D = A.copy(); D[:, -1] = D[:, 0]
    return {
        "well_cond": A, "zero_cols": Z, "tiny_cols": T, "dup_col": D,
        "cond_1e14": (q1 * np.logspace(0, -14, n)) @ q2.T,
        "scaled_1e18": A * 1e18, "scaled_1e-18": A * 1e-18, "zero": np.zeros((n, n)),
        "tall": rng.randn(53, 17),
        "tall_zero_cols": np.hstack([rng.randn(40, 9), np.zeros((40, 4))]),
        "wide": rng.randn(17, 53), "wide_odd": rng.randn(15, 22),
        "one_col": rng.randn(9, 1), "one_row": rng.randn(1, 9),
    }


def _census():
    """Shapes of the maxcut d8 and d10 solves' SVDs, and J1's block regime's
    small sides (24, 34 and 66 wide, 60 from d10's 80 x 60, a ragged last
    block at 34, 66, 118 and 120, an empty one at 34 and 66, J1's bound 128)."""
    rng = np.random.RandomState(1)
    out = {}
    for m, n in [(8, 4), (64, 6), (80, 60), (192, 42), (8, 16), (48, 24), (34, 50), (66, 90),
                 (160, 118), (150, 120), (160, 128)]:
        # a TT split's spread: decaying singular values
        k = min(m, n)
        u, _ = np.linalg.qr(rng.randn(m, k))
        v, _ = np.linalg.qr(rng.randn(n, k))
        out[f"{m}x{n}"] = (u * np.logspace(0, -10, k)) @ v.T
    return out


SVD_CASES = {**_gallery(), **_census()}


def _port_svd(a, start):
    """The port's safe_svd with J1's block regime from order ``start``."""
    with tj.forced(True), _block_from(start, "j1"):
        return [t.numpy() for t in linalg.safe_svd(torch.as_tensor(a))]


def _signs_match(x, y, keep):
    """max |x_j - sign_j y_j| over the columns in ``keep``."""
    if not keep.any():
        return 0.0
    x, y = x[:, keep], y[:, keep]
    sign = np.where(np.sum(x * y, axis=0) < 0, -1.0, 1.0)
    return float(np.max(np.abs(x - y * sign)))


def _separated(vals, rel_gap):
    """Values whose distance to both neighbours exceeds rel_gap * max."""
    vals = np.asarray(vals)
    scale = max(np.abs(vals).max(), 1e-300)
    d = np.abs(np.diff(vals)) / scale
    left = np.r_[np.inf, d]
    right = np.r_[d, np.inf]
    return (left > rel_gap) & (right > rel_gap)


@pytest.mark.parametrize("name", list(SVD_CASES))
def test_jacobi_svd_matches_jax(name, jax_jacobi):
    """Each case in J1's regime of its order and, from BLOCK_TESTED_FROM on,
    also in the block regime."""
    a = SVD_CASES[name]
    uj, sj, vtj = (np.asarray(x) for x in jj.safe_svd(a))
    for start in _crossovers(min(a.shape), "j1"):
        _svd_matches(a, _port_svd(a, start), uj, sj, vtj)


def _svd_matches(a, port, uj, sj, vtj):
    u, s, vt = port
    amax = max(np.abs(a).max(), 1e-300)
    k = min(a.shape)
    assert u.shape == (a.shape[0], k) and s.shape == (k,) and vt.shape == (k, a.shape[1])
    assert np.max(np.abs(s - sj)) <= 1e-12 * max(sj.max(), 1e-300)
    assert np.max(np.abs((u * s) @ vt - a)) <= 1e-13 * amax
    assert np.max(np.abs(u.T @ u - np.eye(k))) <= 1e-13
    assert np.all(np.diff(s) <= 0)
    keep = _separated(s, 1e-5)
    assert _signs_match(u, uj, keep) <= 1e-10
    assert _signs_match(vt.T, vtj.T, keep) <= 1e-10
    # vt rows at s == 0 are zero, as the JAX package's
    assert np.all(vt[s == 0] == 0)


@pytest.mark.parametrize("n", [2, 7, 24, 64, 96, 194, 256, 272])
def test_jacobi_eigh_gallery_matches_jax(n, jax_jacobi):
    """tests/test_jacobi.py's eigh gallery (odd orders padded); in the
    regime of the order and from BLOCK_TESTED_FROM on also through J2's
    block regime (eigh_block_plain), with a ragged last block at 194 and
    an empty one at 272.  (At 128 and
    136 the JAX package's own eigenvectors of the psd_tiny spectrum differ
    from LAPACK's by 6.8e-9 and 5.7e-11 where the gap exceeds 1e-5, past
    the 1e-10 this comparison holds; both of the port's rules agree with
    LAPACK's there to 2e-12: the census test takes those orders.)"""
    rng = np.random.RandomState(1)
    q, _ = np.linalg.qr(rng.randn(n, n))
    for spec in [np.linspace(-3, 5, n), np.zeros(n),
                 np.r_[np.zeros(n // 2), np.logspace(-14, 0, n - n // 2)]]:
        a = (q * spec) @ q.T
        _eigh_matches(0.5 * (a + a.T))


def _eigh_matches(a):
    wj, vj = (np.asarray(x) for x in jj.safe_eigh(a))
    for start in _crossovers(a.shape[0]):
        with _block_from(start):
            _eigh_matches_in_regime(a, wj, vj)


def _eigh_matches_in_regime(a, wj, vj):
    with tj.forced(True):
        w, v = (t.numpy() for t in linalg.safe_eigh(torch.as_tensor(a)))
        w2 = linalg.safe_eigvalsh(torch.as_tensor(a)).numpy()
    n = a.shape[0]
    scale = max(np.abs(wj).max(), 1e-300)
    assert np.array_equal(w, w2)
    assert np.max(np.abs(w - wj)) <= 1e-12 * scale
    grow = max(1.0, n / 64)  # V is a product of ~sweeps n rotations a column
    assert np.max(np.abs(v @ np.diag(w) @ v.T - a)) <= 1e-13 * grow * max(np.abs(a).max(), 1e-300)
    assert np.max(np.abs(v.T @ v - np.eye(n))) <= 1e-13 * grow
    keep = _separated(w, 1e-5)
    assert _signs_match(v, vj, keep) <= 1e-10


@pytest.mark.parametrize("n", [4, 16, 64, 96, 128, 136, 194, 256, 272])
def test_jacobi_eigh_census_orders_match_jax(n, jax_jacobi):
    """The eigen windows' orders (maxcut d8 and d10): an indefinite pencil
    of spread eigenvalues; the block regime's orders (ragged and empty last
    blocks) beside them; each order in its regime and from
    BLOCK_TESTED_FROM on also in the block regime."""
    rng = np.random.RandomState(n)
    q, _ = np.linalg.qr(rng.randn(n, n))
    a = (q * np.r_[np.linspace(-1, 4, n - n // 4), 1e-6 * rng.randn(n // 4)]) @ q.T
    _eigh_matches(0.5 * (a + a.T))


@pytest.mark.parametrize("core,n", [pytest.param("j2", 66, id="66"), pytest.param("j2", 98, id="98"),
                                    pytest.param("j1", 66, id="svd-66"),
                                    pytest.param("j1", 128, id="svd-128")])
def test_jacobi_eigh_block_stop_rule_and_cap(core, n):
    """The block regimes (eigh_block_plain, orthogonalise_block_plain): an
    instance stops after the first outer sweep without a rotation (its
    matrix then unchanged, the sweeps counted) and an instance still
    rotating at the cap comes out NaN, every factor, the others of the
    batch untouched; the regimes' sweeps are outer sweeps
    (kernels.jacobi_sweeps).  J1's quiet instance: orthogonal columns."""
    rng = np.random.RandomState(n)
    q, _ = np.linalg.qr(rng.randn(n, n))
    if core == "j2":
        a = torch.as_tensor(np.stack([(q * np.linspace(-1, 4, n)) @ q.T,
                                      np.diag(np.arange(n) + 1.0)]))
        a = 0.5 * (a + a.mT)
        plain, entry, plan = tj.eigh_block_plain, "jacobi_eigh_core", K.j2_plan
    else:
        a = torch.as_tensor(np.stack([(q * np.logspace(0, -8, n)) @ np.linalg.qr(rng.randn(n, n))[0],
                                      q * (np.arange(n) + 1.0)]))
        plain, entry, plan = tj.orthogonalise_block_plain, "jacobi_orthogonalise", K.j1_plan
    out = plain(a, sweeps=True)
    sweeps = out[-1]
    assert sweeps[1] == 1
    if core == "j2":
        assert torch.equal(out[0][1], torch.arange(n, dtype=a.dtype) + 1.0)
        assert torch.equal(out[1][1], torch.eye(n, dtype=a.dtype))
    else:
        assert torch.equal(out[0][1], a[1]) and torch.equal(out[1][1], torch.eye(n, dtype=a.dtype))
    assert 1 < int(sweeps[0]) < tj.MAX_SWEEPS
    with _block_from(BLOCK_TESTED_FROM, core):
        assert plan(n)[0] == 16
        assert torch.equal(K.jacobi_sweeps(entry, a), sweeps)
    saved = tj.MAX_SWEEPS
    tj.MAX_SWEEPS = int(sweeps[0]) - 1
    try:
        out2 = plain(a, sweeps=True)
    finally:
        tj.MAX_SWEEPS = saved
    assert all(bool(torch.isnan(t[0]).all()) for t in out2[:-1])
    assert all(torch.equal(t2[1], t[1]) for t2, t in zip(out2[:-1], out[:-1]))
    assert out2[-1].tolist() == [int(sweeps[0]) - 1, 1]


@pytest.mark.parametrize("n", [7, 66, 97, 194])
def test_jacobi_eigvalsh_values_alone_keep_eighs_bits(n):
    """safe_eigvalsh through J2 without eigenvectors gives safe_eigh's
    eigenvalues bit for bit, in both regimes (each order in its own and
    from BLOCK_TESTED_FROM on in the block regime) and at odd orders (the
    padded pair found without V: its exact zero, last among the zeros),
    also with exact zero eigenvalues beside the padded one."""
    rng = np.random.RandomState(n)
    q, _ = np.linalg.qr(rng.randn(n, n))
    spec = np.r_[np.zeros(n // 3), np.linspace(-2, 3, n - n // 3)]
    a = torch.as_tensor(0.5 * ((q * spec) @ q.T + ((q * spec) @ q.T).T))
    z = torch.zeros((n, n), dtype=a.dtype)
    z[: n // 2, : n // 2] = a[: n // 2, : n // 2]
    for start in _crossovers(n):
        with _block_from(start), tj.forced(True):
            for x in (a, z):
                w, _ = linalg.safe_eigh(x)
                assert torch.equal(linalg.safe_eigvalsh(x), w)


def test_j2_plan_fits_every_order():
    """Every even order of J2's envelope has a regime whose shared memory
    fits a CTA (232,448 bytes): the element rule below J2_BLOCK_FROM, the
    block regime (a cluster of ceil(n / 16 / 2) CTAs, at most 9) from
    there; the element regime, asked for, at every order, and an error
    past the envelope."""
    for n in range(2, K.J2_MAX_N + 1, 2):
        block, ctas, threads, smem = K.j2_plan(n)
        assert smem <= K.SMEM_LIMIT and threads % 32 == 0 and threads <= 1024
        if n < K.J2_BLOCK_FROM:
            assert block == 0 and ctas in (1, 2, 4, 8)
        else:
            nb = -(-n // K.J2_BLOCK)
            assert block == K.J2_BLOCK and ctas == (nb + nb % 2) // 2 <= 9
        element = K.j2_plan(n, element=True)
        assert element[0] == 0 and element[3] <= K.SMEM_LIMIT
    with pytest.raises(K.KernelError):
        K.j2_plan(K.J2_MAX_N + 2)
    # J1: the element regime (one CTA) below J1_BLOCK_FROM and to 118, the
    # block regime (a cluster of ceil(n / 16 / 2) CTAs, at most 4) from
    # there and at 120-128 whatever the crossover, and asked for at every
    # order
    for n in range(2, K.J1_MAX_N + 1, 2):
        block, ctas, threads, smem = K.j1_plan(n)
        assert smem <= K.SMEM_LIMIT and threads % 32 == 0 and threads <= 1024
        if n < K.J1_BLOCK_FROM and n <= K.J1_ELEMENT_MAX_N:
            assert block == 0 and ctas == 1 and threads == 32 * min(32, n // 2)
        else:
            assert block == K.J1_BLOCK
        nb = -(-n // K.J1_BLOCK)
        blk, ctas, threads, smem = K.j1_plan(n, block=True)
        assert blk == K.J1_BLOCK and ctas == (nb + nb % 2) // 2 <= 4
        assert threads == K.J1_BLOCK ** 2 and smem <= K.SMEM_LIMIT
        if n <= K.J1_ELEMENT_MAX_N:
            assert K.j1_plan(n, element=True)[0] == 0
        else:
            with pytest.raises(K.KernelError):
                K.j1_plan(n, element=True)
    with pytest.raises(K.KernelError):
        K.j1_plan(K.J1_MAX_N + 2)


def test_jacobi_batch_with_a_nonfinite_instance():
    """One NaN instance of a batch comes out NaN, the others bit-equal to
    the batch without it; the same for eigh, and for J1's block regime (an
    SVD whose small side is 34)."""
    rng = np.random.RandomState(4)
    a = torch.as_tensor(rng.randn(3, 12, 7))
    bad = a.clone()
    bad[1, 3, 2] = float("nan")
    s = a @ a.mT
    s_bad = s.clone()
    s_bad[1, 0, 1] = s_bad[1, 1, 0] = float("inf")
    t = torch.as_tensor(rng.randn(3, 40, 34))
    t_bad = t.clone()
    t_bad[1, 5, 30] = float("nan")
    with tj.forced(True), _block_from(BLOCK_TESTED_FROM, "j1"):
        for fn, good, broken in ((linalg.safe_svd, a, bad), (linalg.safe_eigh, s, s_bad),
                                 (linalg.safe_svd, t, t_bad)):
            ref, out = fn(good), fn(broken)
            for r, o in zip(ref, out):
                assert bool(torch.isnan(o[1]).all())
                assert torch.equal(o[[0, 2]], r[[0, 2]])


def test_cpu_keeps_lapack_bits_unless_forced():
    rng = np.random.RandomState(5)
    a = torch.as_tensor(rng.randn(20, 9))
    s = a.T @ a
    K.reset_counts()
    for got, want in ((linalg.safe_svd(a), torch.linalg.svd(a, full_matrices=False)),
                      (linalg.svd_econ(a), torch.linalg.svd(a, full_matrices=False)),
                      (linalg.safe_eigh(s), torch.linalg.eigh(s)),
                      ((linalg.safe_eigvalsh(s),), (torch.linalg.eigvalsh(s),))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.STATS["jacobi_svd"].plain_calls == K.STATS["jacobi_eigh"].plain_calls == 0
    with tj.forced(True):
        linalg.safe_svd(a)
        linalg.svd_econ(a)
        linalg.fast_split_svd(a)
        linalg.safe_eigh(s)
        linalg.safe_eigvalsh(s)
    assert K.STATS["jacobi_svd"].plain_calls == 3 and K.STATS["jacobi_eigh"].plain_calls == 2
    assert K.STATS["jacobi_svd"].launches == K.STATS["jacobi_eigh"].launches == 0
    # float32 operands are upcast and factored by the f64 Jacobi
    with tj.forced(True):
        u, sv, vt = linalg.safe_svd(a.float())
    assert u.dtype == torch.float32 and K.STATS["jacobi_svd"].plain_calls == 4


def test_shape_rules_send_large_factorizations_to_linalg():
    """By shape alone: an SVD whose even-padded small side exceeds
    J1_MAX_N (130), an eigh above J2_MAX_N, and a tall pipeline's QR outside
    K3's envelope go to torch.linalg, counted."""
    rng = np.random.RandomState(6)
    K.reset_counts()
    with tj.forced(True):
        big = torch.as_tensor(rng.randn(140, K.J1_MAX_N + 2))
        assert torch.equal(linalg.safe_svd(big)[1], torch.linalg.svd(big, full_matrices=False)[1])
        tall = torch.as_tensor(rng.randn(600, 6))
        u, s, vt = linalg.safe_svd(tall)
        sym = torch.as_tensor(rng.randn(K.J2_MAX_N + 1, K.J2_MAX_N + 1))
        linalg.safe_eigh(sym + sym.T)
    assert K.STATS["jacobi_svd"].outside == 1 and K.STATS["jacobi_svd"].plain_calls == 1
    assert K.STATS["panel_qr"].outside == 1
    assert K.STATS["jacobi_eigh"].outside == 1
    assert float(torch.abs((u * s) @ vt - tall).max()) < 1e-13 * float(tall.abs().max())


def test_round_robin_closed_form():
    """The kernels' closed form of the schedule (csrc/jacobi.cuh) is the
    JAX package's _round_robin."""
    for n in (2, 4, 10, 64):
        ii, jj_ = jj._round_robin(n)
        assert (np.asarray(tj.round_robin(n)[0]) == ii).all()
        assert (np.asarray(tj.round_robin(n)[1]) == jj_).all()
        for k in range(n - 1):
            pos = [0] + [1 + (p - 1 - k) % (n - 1) for p in range(1, n)]
            assert pos[: n // 2] == list(ii[k]) and pos[::-1][: n // 2] == list(jj_[k])


def test_jacobi_slice_matches_jax():
    """maxcut d3 seed 319 through the port on the CPU with every SVD and
    eigh on the plain Jacobi (as the card runs them) against the JAX
    package's d3 solve (tests/test_torch_ipm.py's settings): the same
    iterations and final ranks, <C, X> within 1e-6 relative."""
    from tests.test_torch_ipm import SETTINGS
    from ttipm_tpu.ipm import tt_ipm as ipm_j
    from ttipm_tpu.models.maxcut import create_problem as cp_j
    from ttipm_tpu.ops import tt as J
    from ttipm_tpu_torch import config as tconfig
    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import tt_ipm as ipm_t
    from ttipm_tpu_torch.models.maxcut import create_problem as cp_t
    from ttipm_tpu_torch.ops import tt as T

    np.random.seed(319)
    obj_j, L_j, b_j, lag_j = cp_j(3, 1)
    X_j, _, _, _, info_j = ipm_j({"y": J.tt_reshape(lag_j, (4, 4))}, obj_j, L_j, b_j,
                                 **SETTINGS)
    tconfig.set_rank_bucket(1)
    try:
        np.random.seed(319)
        obj_t, L_t, b_t, lag_t = cp_t(3, 1, device="cpu")
        K.reset_counts()
        with tj.forced(True):
            X_t, Y_t, _, Z_t, info_t = ipm_t({"y": T.tt_reshape(lag_t, (4, 4))}, obj_t, L_t,
                                             b_t, **SETTINGS)
    finally:
        tconfig.set_rank_bucket(4)
    assert K.STATS["jacobi_svd"].plain_calls > 0 and K.STATS["jacobi_eigh"].plain_calls > 0
    assert info_t["num_iters"] == info_j["num_iters"]
    assert info_t["ranksX"] == info_j["ranksX"] and info_t["ranksZ"] == info_j["ranksZ"]
    cx_j = J.tt_inner_prod(J.tt_reshape(obj_j, (2, 2)), X_j)
    cx_t = T.tt_inner_prod(T.tt_reshape(obj_t, (2, 2)), X_t)
    assert cx_t == pytest.approx(cx_j, rel=1e-6)
    slack, feas, dfeas = solve_metrics(X_t, Y_t, Z_t, obj_t, L_t, b_t)
    assert slack < 1e-3 and feas < 1e-3 and dfeas < 1e-3
