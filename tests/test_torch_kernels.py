"""The port's four kernel wrappers (ttipm_tpu_torch/ops/kernels.py).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels run as its own tests run them
(``interpret=True``): f32 for the Schur assembly, the panel QR and the
panel Cholesky with the tolerances of tests/test_kernels.py, f64 for the
block matvec and for the Schur assembly's XLA path.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttipm_tpu.ops import kernels as JK
from ttipm_tpu_torch.checks import check_kernel
from ttipm_tpu_torch.ops import kernels as K


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("dims", [(5, 3, 4, 4, 4, 3, 5, 4), (3, 1, 6, 4, 4, 2, 2, 5)])
def test_kkt_block_matvec_plain_matches_pallas(dims):
    l, s, r, m, n, S, L, R = dims
    rng = np.random.RandomState(0)
    pl, A, pr, x = (rng.randn(l, s, r), rng.randn(s, m, n, S), rng.randn(L, S, R),
                    rng.randn(r, n, R))
    want = np.asarray(JK.kkt_block_matvec(*(jnp.asarray(t) for t in (pl, A, pr, x)),
                                          interpret=True))
    got = K.kkt_block_matvec(*(torch.as_tensor(t) for t in (pl, A, pr, x)))
    assert tuple(got.shape) == (l, m, L)
    assert rel(got.numpy(), want) < 1e-12


def test_schur_assemble_plain_matches_pallas():
    rng = np.random.RandomState(1)
    l = r = L = R = 8
    s = S = 6
    pl = rng.randn(l, s, r).astype(np.float32)
    A = rng.randn(s, 4, 4, S).astype(np.float32)
    pr = rng.randn(L, S, R).astype(np.float32)
    want = np.asarray(JK.schur_assemble(jnp.asarray(pl), jnp.asarray(A), jnp.asarray(pr),
                                        interpret=True))
    got = K.schur_assemble(torch.as_tensor(pl), torch.as_tensor(A), torch.as_tensor(pr))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    # f64 against the XLA path, including a 16-wide operator core (the
    # merged two-core window of the eigensolver)
    for shape_a in ((3, 4, 4, 2), (2, 16, 16, 3)):
        pl = rng.randn(5, shape_a[0], 5)
        A = rng.randn(*shape_a)
        pr = rng.randn(3, shape_a[-1], 3)
        want = np.asarray(JK.schur_assemble_xla(jnp.asarray(pl), jnp.asarray(A), jnp.asarray(pr)))
        got = K.schur_assemble(torch.as_tensor(pl), torch.as_tensor(A), torch.as_tensor(pr))
        assert rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("mn", [(32, 8), (48, 12), (7, 3), (16, 16), (24, 6, "deficient")])
def test_panel_qr_plain_matches_pallas(mn):
    m, n = mn[:2]
    a = np.random.RandomState(m).randn(m, n).astype(np.float32)
    if len(mn) > 2:  # a repeated and a zero column: Q is not unique, the contract holds
        a[:, 3] = a[:, 1]
        a[:, 4] = 0.0
    qj, rj = (np.asarray(t) for t in JK.panel_qr(jnp.asarray(a), interpret=True))
    q, r = (t.numpy() for t in K.panel_qr(torch.as_tensor(a)))
    scale = np.abs(a).max()
    assert np.abs(q @ r - a).max() < 5e-6 * scale * max(m, n) ** 0.5
    assert np.abs(q.T @ q - np.eye(n)).max() < 5e-6 * n
    assert np.abs(np.tril(r, -1)).max() == 0.0
    assert np.abs(qj @ rj - a).max() < 5e-6 * scale * max(m, n) ** 0.5
    assert np.abs(qj.T @ qj - np.eye(n)).max() < 5e-6 * n
    if len(mn) > 2:
        return
    # the same factors up to column signs (the Pallas kernel reflects a
    # column that is already reduced, LAPACK leaves it)
    dj, d = np.sign(np.diag(rj)), np.sign(np.diag(r))
    assert np.abs(q * d - qj * dj).max() < 1e-4
    assert np.abs(d[:, None] * r - dj[:, None] * rj).max() < 1e-4 * scale


@pytest.mark.parametrize("n", [4, 12, 32, 96])
def test_panel_cholesky_plain_matches_pallas(n):
    rng = np.random.RandomState(n)
    B = rng.randn(n, n).astype(np.float32)
    A = B @ B.T + n * np.eye(n, dtype=np.float32)
    Lj = np.asarray(JK.panel_cholesky(jnp.asarray(A), interpret=True))
    L, info = K.panel_cholesky(torch.as_tensor(A))
    assert int(info) == 0
    L = L.numpy()
    assert np.allclose(L, np.tril(L))
    assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) < 5e-6
    assert np.abs(L - Lj).max() < 1e-3 * np.abs(Lj).max()


def test_panel_cholesky_reports_failure():
    rng = np.random.RandomState(3)
    B = rng.randn(20, 20)
    A = B @ B.T + 20 * np.eye(20)
    A[7, 7] = -1.0
    _, info = K.panel_cholesky(torch.as_tensor(A))
    assert int(info) == 8  # 1-based order of the first failing minor


@pytest.mark.parametrize("shape", [(3, 4), (2, 3, 3), (4,)])
def test_panel_cholesky_takes_one_square_matrix(shape):
    """K4 factors a single square matrix: anything else is refused on every
    device, before any kernel is built and without a plain call."""
    K.reset_counts()
    with pytest.raises(K.KernelError):
        K.panel_cholesky(torch.zeros(shape, dtype=torch.float64))
    assert (K.STATS["panel_cholesky"].launches, K.STATS["panel_cholesky"].plain_calls) == (0, 0)


def test_panel_cholesky_bounds_match_the_cuda_source():
    """The wrapper's resident bound and panel width (which size the blocked
    regime's workspace) are the constants of csrc/panel_cholesky.cu."""
    import os
    import re

    from ttipm_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "panel_cholesky.cu")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kResidentMaxN"]) == K.K4_RESIDENT_MAX_N
    assert int(consts["kNB"]) == K.K4_PANEL


def test_panel_cholesky_plain_reads_any_strides():
    """On the CPU a transposed view gives the plain factor of the matrix it
    shows (the CUDA kernel reads strides too; tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(8)
    B = rng.randn(12, 12)
    A = torch.as_tensor(B @ B.T + 12 * np.eye(12))
    L, info = K.panel_cholesky(A.T)
    assert int(info) == 0
    np.testing.assert_allclose((L @ L.T).numpy(), A.numpy(), rtol=0, atol=1e-12)


def test_wrappers_count_plain_calls_on_cpu():
    K.reset_counts()
    rng = np.random.RandomState(4)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    K.kkt_block_matvec(t(2, 1, 3), t(1, 4, 4, 1), t(2, 1, 3), t(3, 4, 3))
    K.schur_assemble(t(2, 1, 3), t(1, 4, 4, 1), t(2, 1, 3))
    K.panel_qr(t(8, 3))
    K.panel_cholesky(torch.eye(5, dtype=torch.float64))
    K.jacobi_orthogonalise(t(2, 6, 6))
    K.jacobi_eigh_core(torch.eye(4, dtype=torch.float64).expand(2, 4, 4))
    for name, stats in K.STATS.items():
        assert (stats.launches, stats.plain_calls) == (0, 1), name


def test_wrappers_reject_other_devices():
    a = torch.empty((8, 3), dtype=torch.float64, device="meta")
    with pytest.raises(K.KernelError):
        K.panel_qr(a)
    with pytest.raises(K.KernelError):
        K.schur_assemble(torch.zeros(2, 1, 3, dtype=torch.float64),
                         torch.zeros(1, 4, 4, 1, dtype=torch.float64, device="meta"),
                         torch.zeros(2, 1, 3, dtype=torch.float64))


def _check_cases(rng):
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    B = t(24, 24)
    return {
        "kkt_block_matvec": (t(3, 2, 5), t(2, 4, 4, 3), t(6, 3, 4), t(5, 4, 4)),
        "schur_assemble": (t(3, 2, 5), t(2, 16, 16, 3), t(6, 3, 4)),
        "panel_qr": (t(24, 6),),
        "panel_cholesky": (B @ B.T + 24 * torch.eye(24, dtype=torch.float64),),
        "jacobi_orthogonalise": (t(2, 12, 12),),
        "jacobi_eigh_core": ((B @ B.T)[None, :12, :12].contiguous(),),
    }


# The entry point through which each kernel's check is exercised.
_ENTRY = {"jacobi_svd": "jacobi_orthogonalise", "jacobi_eigh": "jacobi_eigh_core"}


@pytest.mark.parametrize("name", sorted(K.STATS))
def test_check_kernel_accepts_plain_and_rejects_perturbed(name):
    """The shared acceptance check (chip_smoke.py and the CUDA tests) passes
    the wrapper's own output and refuses one perturbed past its tolerance,
    without moving the wrapper's counters."""
    name = _ENTRY.get(name, name)
    args = _check_cases(np.random.RandomState(5))[name]
    out = getattr(K, name)(*args)
    K.reset_counts()
    errs = check_kernel(name, args, out)
    assert errs.get("max_abs_err", 0.0) == 0.0
    assert all((s.launches, s.plain_calls) == (0, 0) for s in K.STATS.values())
    if name == "panel_qr":
        bad = (out[0], out[1] + 1e-9 * torch.tril(torch.ones_like(out[1])))
    elif name == "panel_cholesky":
        bad = (out[0] * (1 + 1e-9), out[1])
    elif name == "jacobi_orthogonalise":
        bad = (out[0], out[1] * (1 + 1e-9), out[2])
    elif name == "jacobi_eigh_core":
        bad = (out[0] * (1 + 1e-9), out[1])
    else:
        bad = out * (1 + 1e-9)
    with pytest.raises(AssertionError):
        check_kernel(name, args, bad)
    if name == "panel_cholesky":
        with pytest.raises(AssertionError):
            check_kernel(name, args, (out[0], out[1] + 3))


@pytest.mark.parametrize("name", ["kkt_block_matvec", "schur_assemble"])
def test_check_kernel_nonfinite_operands(name):
    """A NaN operand (a candidate the solver rejects): the check passes an
    output that is non-finite exactly where the plain version's is and
    within tolerance elsewhere, and refuses one that is not."""
    args = _check_cases(np.random.RandomState(7))[name]
    args[1][0, 1, 2, 0] = float("nan")  # entry (m, n) = (1, 2) of the operator core
    out = getattr(K, name)(*args)
    assert not bool(torch.isfinite(out).all()) and bool(torch.isfinite(out).any())
    errs = check_kernel(name, args, out)
    assert errs["nonfinite"] > 0 and errs["max_abs_err"] == 0.0
    finite_wrong = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    with pytest.raises(AssertionError):
        check_kernel(name, args, finite_wrong)
    nan_wrong = out.clone()
    nan_wrong[torch.isfinite(out).nonzero()[0].unbind()] = float("nan")
    with pytest.raises(AssertionError):
        check_kernel(name, args, nan_wrong)
    with pytest.raises(AssertionError):
        check_kernel(name, args, out * (1 + 1e-9))


def test_check_kernel_scales_cancelling_contractions():
    """On the solver's operands (``cancelling=True``) a block matvec is held
    to the scale of its terms: a result that cancels to 1e-12 of its terms
    may carry a rounding error of 1e-15 of them, and no more."""
    rng = np.random.RandomState(6)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    pl, A, pr, x = t(3, 1, 5), t(1, 4, 4, 1), t(6, 1, 4), t(5, 4, 4)
    args = (torch.cat([pl, pl], 1), torch.cat([A, -A * (1 + 1e-12)], 0), pr, x)
    y1 = K.kkt_block_matvec_plain(pl, A, pr, x)
    out = K.kkt_block_matvec_plain(*args) + 1e-15 * y1
    errs = check_kernel("kkt_block_matvec", args, out, cancelling=True)
    assert errs["rel_terms"] <= 1e-15 < 1e-4 < errs["rel"]
    with pytest.raises(AssertionError):
        check_kernel("kkt_block_matvec", args, out)
    with pytest.raises(AssertionError):
        check_kernel("kkt_block_matvec", args, out + 1e-9 * y1, cancelling=True)


# ---------------------------------------------------------------------------
# Grouped entries of K2 and K1: kkt_block_product, schur_assemble_group
# ---------------------------------------------------------------------------

KEYS = ("00", "01", "12", "21", "22")


def _kkt_operands(rng, left, right, ranks):
    """Interfaces (l, s, r) / (L, S, R) per key with the outer dims given
    per side as (l, r) and (L, R), and operator cores (s, 4, 4, S)."""
    pl = {k: rng.randn(left[0], ranks[k][0], left[1]) for k in KEYS}
    pr = {k: rng.randn(right[0], ranks[k][1], right[1]) for k in KEYS}
    A = {k: rng.randn(ranks[k][0], 4, 4, ranks[k][1]) for k in KEYS}
    return pl, A, pr


RANKS = {"00": (3, 2), "01": (2, 4), "12": (1, 1), "21": (4, 3), "22": (2, 2)}


def _jax_algebra():
    from ttipm_tpu.solvers.fused_algebra import make_algebra

    return make_algebra(np.einsum, np, lambda ineq: KEYS, lambda ineq: 3)


def _torch_dict(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def test_local_product_matches_jax_algebra():
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    rng = np.random.RandomState(10)
    pl, A, pr = _kkt_operands(rng, (5, 5), (3, 3), RANKS)
    x = rng.randn(5, 3, 4, 3)
    want = _jax_algebra().local_product(pl, A, pr, x, False)
    K.reset_counts()
    got = fb.local_product(*b1((_torch_dict(pl), _torch_dict(A), _torch_dict(pr),
                                torch.as_tensor(x))))[0]
    assert K.STATS["kkt_block_matvec"].plain_calls == 1  # one wrapper call a product
    assert tuple(got.shape) == want.shape == (5, 3, 4, 3)
    assert rel(got.numpy(), want) < 1e-12


def test_z_product_matches_jax_algebra():
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    rng = np.random.RandomState(11)
    zl, A, zr = _kkt_operands(rng, (2, 5), (4, 3), RANKS)
    zl["10"] = rng.randn(2, RANKS["01"][0], 5)
    zr["10"] = rng.randn(4, RANKS["01"][1], 3)
    x = rng.randn(5, 3, 4, 3)
    want = _jax_algebra().z_product(zl, A, zr, x, False)
    K.reset_counts()
    got = fb.z_product(*b1((_torch_dict(zl), _torch_dict(A), _torch_dict(zr),
                            torch.as_tensor(x))))[0]
    assert K.STATS["kkt_block_matvec"].plain_calls == 1
    assert tuple(got.shape) == want.shape == (2, 3, 4, 4)
    assert rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("transpose_right_phi", [False, True])
def test_mixed_product_matches_jax_algebra(transpose_right_phi):
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    rng = np.random.RandomState(12)
    if transpose_right_phi:  # x basis on the left, z basis on the right
        ml, A, mr = _kkt_operands(rng, (5, 5), (4, 3), RANKS)
        mr["10"] = rng.randn(4, RANKS["01"][1], 3)
    else:                    # z basis on the left, x basis on the right
        ml, A, mr = _kkt_operands(rng, (2, 5), (3, 3), RANKS)
        ml["10"] = rng.randn(2, RANKS["01"][0], 5)
    x = rng.randn(5, 3, 4, 3)
    want = _jax_algebra().mixed_product(ml, mr, A, x, False, transpose_right_phi)
    K.reset_counts()
    got = fb.mixed_product(*b1((_torch_dict(ml), _torch_dict(mr), _torch_dict(A),
                                torch.as_tensor(x))), transpose_right_phi)[0]
    assert K.STATS["kkt_block_matvec"].plain_calls == 1
    assert rel(got.numpy(), want) < 1e-12


def _random_terms(rng, l=3, m=4, L=5):
    """Six terms over three rows with unequal ranks, one on flipped and
    transposed views, x as strided columns of one core."""
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    x = t(6, 3, 4, 2)
    terms = []
    for row, col, (s, S) in [(0, 0, (3, 2)), (0, 1, (1, 4)), (1, 2, (2, 2)), (2, 1, (4, 1)),
                             (2, 2, (2, 3))]:
        terms.append((t(l, s, 6), t(s, m, 4, S), t(L, S, 2), x[:, col], row))
    flipped = (t(6, 2, l).permute(2, 1, 0), t(2, 4, m, 3).transpose(1, 2),
               t(2, 3, L).permute(2, 1, 0), x[:, 0], 1)
    return terms[:2] + [flipped] + terms[2:]


def test_kkt_block_product_plain_sums_its_rows():
    rng = np.random.RandomState(13)
    terms = _random_terms(rng)
    got = K.kkt_block_product(terms, 4)  # row 3 has no term
    assert tuple(got.shape) == (3, 4, 4, 5)
    want = np.zeros((3, 4, 4, 5))
    for pl, A, pr, x, row in terms:
        want[:, row] += np.asarray(JK.kkt_block_matvec(
            *(jnp.asarray(np.ascontiguousarray(v.numpy())) for v in (pl, A, pr, x)),
            interpret=True))
    assert rel(got.numpy(), want) < 1e-12
    assert float(got[:, 3].abs().max()) == 0.0


def test_schur_assemble_group_plain_matches_xla_per_block():
    rng = np.random.RandomState(14)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    # square blocks (the XLA path reshapes to (m, m))
    blocks = [(t(3, s, 3), t(s, 4, 4, S), t(5, S, 5)) for s, S in [(2, 3), (1, 1), (4, 2)]]
    blocks.append((t(3, 2, 3).permute(2, 1, 0), t(2, 4, 4, 3).transpose(1, 2),
                   t(5, 3, 5).permute(2, 1, 0)))
    got = K.schur_assemble_group(blocks)
    assert len(got) == 4
    for b, g in zip(blocks, got):
        want = np.asarray(JK.schur_assemble_xla(*(jnp.asarray(v.numpy()) for v in b)))
        assert tuple(g.shape) == want.shape == (60, 60)
        assert rel(g.numpy(), want) < 1e-12


def _read_packed(ptr, shape, strides):
    """The array a kernel would read at address ``ptr`` through ``shape``
    and element ``strides``."""
    import ctypes

    extent = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    flat = np.ctypeslib.as_array((ctypes.c_double * extent).from_address(ptr))
    return np.lib.stride_tricks.as_strided(flat, shape, [8 * st for st in strides])


def test_term_table_packing_reproduces_the_operands():
    """Each packed K2 term (addresses, dims, element strides, row) and K1
    block reads back as its operand, for contiguous, flipped and transposed
    operands and for x columns of a block core."""
    rng = np.random.RandomState(15)
    terms = _random_terms(rng)
    assert not terms[2][0].is_contiguous() and not terms[2][1].is_contiguous()
    dims = K._k2_check(terms, 3)
    words = K.pack_k2_terms(terms, dims)
    assert len(words) == 26 * len(terms)
    for i, (term, d) in enumerate(zip(terms, dims)):
        w = words[26 * i:26 * (i + 1)]
        l, s, r, m, n, S, L, R = w[4:12]
        assert (l, s, r, m, n, S, L, R) == d
        assert w[25] == term[4]
        shapes = [(l, s, r), (s, m, n, S), (L, S, R), (r, n, R)]
        strides = [w[12:15], w[15:19], w[19:22], w[22:25]]
        for ptr, shape, st, operand in zip(w[:4], shapes, strides, term[:4]):
            np.testing.assert_array_equal(_read_packed(ptr, shape, st), operand.numpy())
    blocks = [t[:3] for t in terms]
    bdims = tuple(K._dims("schur_assemble", b) for b in blocks)
    words = K.pack_k1_blocks(blocks, bdims)
    assert len(words) == 21 * len(blocks)
    for i, (b, d) in enumerate(zip(blocks, bdims)):
        w = words[21 * i:21 * (i + 1)]
        assert tuple(w[3:11]) == d
        l, s, r, m, n, S, L, R = d
        for ptr, shape, st, operand in zip(w[:3], [(l, s, r), (s, m, n, S), (L, S, R)],
                                           [w[11:14], w[14:18], w[18:21]], b):
            np.testing.assert_array_equal(_read_packed(ptr, shape, st), operand.numpy())


def _check_k2_plan(dims, plan):
    """The plan's buffers hold the widest term and fit a CTA; returns the
    doubles of its t1 and t2."""
    lc, rt, threads, smem, cap1, cap2, cap_phl, cap_x, cap_a, cap_phr = plan
    l, _, _, m, _, _, L, _ = dims[0]
    t1 = max(s * n * lc * min(rt, R) for _, s, _, _, n, _, _, R in dims)
    t2 = max(lc * m_ * ((S * min(rt, R)) | 1) for _, _, _, m_, _, S, _, R in dims)
    assert (cap1, cap2) == (t1, t2)
    assert 1 <= lc <= l and 1 <= rt <= max(d[7] for d in dims)
    assert smem == 8 * (2 * lc * m * L + t1 + t2 + cap_phl + cap_x + cap_a + cap_phr)
    assert smem <= K.SMEM_LIMIT == 232448
    assert threads == (512 if max(t1, t2) > 256 else 256)
    # a staged operand's buffer holds the widest term's slice, or is absent
    assert cap_phr in (0, max(S * min(rt, R) * (L | 1) for _, _, _, _, _, S, _, R in dims))
    assert cap_a in (0, max(s * m_ * n * S for _, s, _, m_, n, S, _, _ in dims))
    assert cap_x in (0, max(r * n * min(rt, R) for _, _, r, _, n, _, _, R in dims))
    assert cap_phl in (0, max(lc * s * r for _, s, r, _, _, _, _, _ in dims))
    return t1, t2


@pytest.mark.parametrize("nrows", [1, 3])
def test_k2_tile_chooser_fits_every_shape(nrows):
    """For bond ranks up to 36 and operator ranks up to 100 the chooser
    refuses nothing: its chunk of l, tile of R and staged operands fit the
    232,448 bytes a CTA may use, and R is cut only where one value of l
    does not fit."""
    ranks = sorted(set(range(1, 101, 3)) | {9, 99, 100})
    for R in range(1, 37):
        for s in ranks:
            for S in ranks:
                dims = ((R, s, R, 4, 4, S, R, R),)
                plan = K.k2_tiles(dims, nrows)
                _check_k2_plan(dims, plan)
                if plan[1] < R:
                    assert plan[0] == 1
                    assert 8 * (2 * 4 * R + s * 4 * R + 4 * ((S * R) | 1)) > K.SMEM_LIMIT
    # the usual shapes stage all four operands
    assert all(K.k2_tiles(((R, s, R, 4, 4, s, R, R),), 3)[6:] for R, s in ((8, 4), (32, 9)))
    # the bound case named in the kernel's notes: one l at R = 36, s = S = 100
    assert K.k2_tiles(((36, 100, 36, 4, 4, 100, 36, 36),), 3)[:2] == (1, 18)
    # terms of unequal rank size the buffers by the widest
    dims = ((8, 4, 8, 4, 4, 4, 8, 8), (8, 9, 8, 4, 4, 1, 8, 8))
    plan = K.k2_tiles(dims, 3)
    assert _check_k2_plan(dims, plan) == (9 * 4 * plan[0] * 8, plan[0] * 4 * 33)
    with pytest.raises(K.KernelError):
        K.k2_tiles(((1, 40000, 1, 4, 4, 1, 1, 1),), 1)


def test_k1_tile_chooser_fits_every_shape():
    for R in (1, 2, 8, 16, 32, 36):
        for s in (1, 4, 9, 100, 1000, 5000):
            for groups in (1, 2, 4):
                dims = ((R, s, R, 4, 4, s, R, R),) * groups
                tm, sc, colsplit = K.k1_tiles(dims)
                assert tm in (16, 32, 64) and 1 <= sc <= s and colsplit >= 1
                assert 8 * (tm * (sc | 1) + 32 * 65) <= K.SMEM_LIMIT
    assert K.k1_tiles(((8, 4, 8, 4, 4, 4, 8, 8),) * 4) == (16, 4, 1)
    assert K.k1_tiles(((32, 9, 32, 4, 4, 9, 32, 32),)) == (64, 9, 1)


@pytest.mark.parametrize("batch", [2, 5, 10, 40])
def test_batch_plans_keep_an_instances_arithmetic(batch):
    """A batched launch shares the card between its instances, so its plan
    may take a larger chunk of l (K2) or another row tile (K1), but K2's tile of
    R, the only choice that orders a sum, is the single launch's: an
    instance of a batch sums as a single launch on it does."""
    for R in (1, 4, 8, 16, 32, 36):
        for s in (1, 4, 9, 100):
            dims = ((R, s, R, 4, 4, s, R, R),)
            for nrows in (1, 3):
                one, many = K.k2_tiles(dims, nrows), K.k2_tiles(dims, nrows, batch=batch)
                assert many[1] == one[1] and many[0] >= one[0]
                _check_k2_plan(dims, many)
            tm, sc, colsplit = K.k1_tiles(dims * 4, batch=batch)
            assert tm in (16, 32, 64) and 1 <= sc <= s and colsplit >= 1
            assert 8 * (tm * (sc | 1) + 32 * 65) <= K.SMEM_LIMIT


def test_grouped_wrappers_count_and_refuse():
    rng = np.random.RandomState(16)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    terms = _random_terms(rng)
    blocks = [(t(3, 2, 5), t(2, 4, 4, 3), t(2, 3, 6)), (t(3, 1, 5), t(1, 4, 4, 1), t(2, 1, 6))]
    K.reset_counts()
    K.kkt_block_product(terms, 3)
    K.schur_assemble_group(blocks)
    for name in ("kkt_block_matvec", "schur_assemble"):
        s = K.STATS[name]
        assert (s.launches, s.grouped, s.plain_calls) == (0, 0, 1), name
    meta = torch.zeros(3, 2, 5, dtype=torch.float64, device="meta")
    bad_calls = [
        lambda: K.kkt_block_product([], 3),                              # no terms
        lambda: K.kkt_block_product(terms * 3, 3),                       # too many terms
        lambda: K.kkt_block_product(terms, 2),                           # row 2 of 2
        lambda: K.kkt_block_product(terms + [(t(4, 1, 6), t(1, 4, 4, 1), t(5, 1, 2),
                                              terms[0][3], 0)], 3),      # another l
        lambda: K.kkt_block_product([(t(3, 2, 6), t(3, 4, 4, 1), t(5, 1, 2),
                                      terms[0][3], 0)], 3),              # bond mismatch
        lambda: K.kkt_block_product([(meta,) + terms[0][1:]], 3),        # devices differ
        lambda: K.schur_assemble_group([]),
        lambda: K.schur_assemble_group(blocks + [(t(2, 2, 5), t(2, 4, 4, 3), t(2, 3, 6))]),
        lambda: K.schur_assemble_group([(t(3, 2, 5), t(3, 4, 4, 3), t(2, 3, 6))]),
        lambda: K.schur_assemble_group([(meta, blocks[0][1], blocks[0][2])]),
        lambda: K.schur_assemble_group([blocks[0]] * (K.K1_MAX_BLOCKS + 1)),
    ]
    K.reset_counts()
    for i, call in enumerate(bad_calls):
        with pytest.raises(K.KernelError):
            call()
            pytest.fail(f"call {i} was not refused")
    assert all((s.launches, s.plain_calls) == (0, 0) for s in K.STATS.values())


def test_kernel_sources_match_the_wrappers_constants():
    """Table widths, term and block limits and tile sizes that the Python
    side packs and chooses by are the constants of the CUDA sources."""
    import os
    import re

    from ttipm_tpu_torch.ops import _build

    def consts(name):
        with open(os.path.join(_build.CSRC, name)) as fh:
            return {k: int(v) for k, v in
                    re.findall(r"constexpr int (k\w+) = (\d+);", fh.read())}

    k2, k1 = consts("kkt_matvec.cu"), consts("schur_assemble.cu")
    assert (k2["kMaxTerms"], k2["kTermWords"], k2["kMaxDynamicSmem"], k2["kMaxThreads"]) == (
        K.K2_MAX_TERMS, 26, K.SMEM_LIMIT, 512)
    assert k2["kPlanWords"] == len(K.k2_tiles(((8, 4, 8, 4, 4, 4, 8, 8),), 3)) == 10
    assert (k1["kMaxBlocks"], k1["kBlockWords"], k1["kMaxDynamicSmem"]) == (
        K.K1_MAX_BLOCKS, 21, K.SMEM_LIMIT)
    # a batch stride for each operand: phi_l, A, phi_r (and x in K2)
    assert (k1["kBatchWords"], k2["kBatchWords"]) == (3, 4)
    assert (k1["kTN"], k1["kKS"]) == (K._K1_TN, K._K1_KS)


# ---------------------------------------------------------------------------
# K3: launch plan, layouts, and the split steps that call it
# ---------------------------------------------------------------------------

def test_k3_plan_fits_every_shape_of_the_envelope():
    """Every panel with n <= m <= 512, n <= 128 gets a plan that fits the
    232,448 bytes a CTA may use: one CTA up to 192 rows, else the smallest
    cluster whose row slabs have at most 192."""
    assert (K.K3_MAX_M, K.K3_MAX_N, K.K3_SLAB_ROWS) == (512, 128, 192)
    for n in range(1, K.K3_MAX_N + 1):
        for m in range(n, K.K3_MAX_M + 1):
            ctas, threads, ws, smem = K.k3_plan(m, n)
            rows = -(-m // ctas)
            assert smem == 8 * ((rows | 1) * n + 3 * n) <= K.SMEM_LIMIT == 232448
            assert ctas in (1, 2, 4) and rows <= K.K3_SLAB_ROWS
            assert ctas * rows >= m > (ctas - 1) * rows  # every CTA has rows
            assert ctas == 1 or -(-m // (ctas // 2)) > K.K3_SLAB_ROWS  # no smaller cluster
            assert threads == 32 * min(n, 16 if ctas == 1 else 32) <= K.K3_MAX_THREADS
            assert ws == (0 if ctas == 1 else 2 * (ctas + 1) * n + 3 * ctas)
    # every panel of the solve (4 R' x (R + kick), R <= 32) is one CTA
    assert all(K.k3_plan(4 * R, R + 4)[0] == 1 for R in range(2, 37))
    assert K.k3_plan(24, 6)[:2] == (1, 192) and K.k3_plan(144, 36)[:2] == (1, 512)
    assert K.k3_plan(192, 20)[0] == 1 and K.k3_plan(193, 20)[0] == 2
    assert K.k3_plan(384, 20)[0] == 2 and K.k3_plan(385, 20)[0] == 4
    assert K.k3_plan(512, 128)[:2] == (4, 1024)


@pytest.mark.parametrize("mn", [(513, 10), (512, 129), (600, 200), (3, 5), (4, 0)])
def test_k3_plan_refuses_on_shape_alone(mn):
    with pytest.raises(K.KernelError):
        K.k3_plan(*mn)


def test_panel_qr_constants_match_the_cuda_source():
    import os
    import re

    from ttipm_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "panel_qr.cu")) as fh:
        c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", fh.read())}
    assert (c["kMaxM"], c["kMaxN"], c["kMaxCtas"], c["kMaxThreads"]) == (
        K.K3_MAX_M, K.K3_MAX_N, K.K3_MAX_CTAS, K.K3_MAX_THREADS)
    assert c["kMaxThreadsOneCta"] == K.K3_ONE_CTA_THREADS
    assert (c["kMaxDynamicSmem"], c["kScalarRows"]) == (K.SMEM_LIMIT, K._K3_SCALAR_ROWS)
    assert c["kMaxSlabRows"] == K.K3_SLAB_ROWS and K.K3_SLAB_ROWS % 32 == 0


@pytest.mark.parametrize("view", ["contiguous", "transposed", "strided"])
def test_panel_qr_plain_layouts(view):
    """The transposed-output option is q.T bit for bit, as a contiguous
    (n, m) array, on contiguous and non-contiguous operands."""
    rng = np.random.RandomState(21)
    if view == "contiguous":
        a = torch.as_tensor(rng.randn(20, 6))
    elif view == "transposed":
        a = torch.as_tensor(rng.randn(6, 20)).T
    else:
        a = torch.as_tensor(rng.randn(40, 12))[::2, ::2]
    assert a.is_contiguous() == (view == "contiguous")
    K.reset_counts()
    q, r = K.panel_qr(a)
    qt, rt = K.panel_qr(a, transposed=True)
    assert K.STATS["panel_qr"].plain_calls == 2
    assert tuple(qt.shape) == (6, 20) and qt.is_contiguous()
    assert torch.equal(qt, q.T) and torch.equal(rt, r)
    check_kernel("panel_qr", (a,), (q, r))
    np.testing.assert_allclose((q @ r).numpy(), a.numpy(), rtol=0, atol=1e-13)
    with pytest.raises(K.KernelError):
        K.panel_qr(torch.zeros(2, 3, 4, dtype=torch.float64))


def _split_operands(rng, direction):
    """Operands of one split step with a solve: bond ranks 3 | 4, block
    size 3, mode size 4, operator ranks of RANKS, z ranks 2 | 2."""
    rl, rr, rz, rz1, n, bs = 3, 4, 2, 2, 4, 3
    x_shape, z_shape = (rl, bs, n, rr), (rz, bs, n, rz1)
    pl = {k: rng.randn(rl, RANKS[k][0], rl) for k in KEYS}
    pr = {k: rng.randn(rr, RANKS[k][1], rr) for k in KEYS}
    zl = {k: rng.randn(rz, RANKS[k][0], rl) for k in KEYS}
    zr = {k: rng.randn(rz1, RANKS[k][1], rr) for k in KEYS}
    zl["10"] = rng.randn(rz, RANKS["01"][0], rl)
    zr["10"] = rng.randn(rz1, RANKS["01"][1], rr)
    A = {k: rng.randn(RANKS[k][0], 4, 4, RANKS[k][1]) for k in KEYS}
    sb = 2  # right-hand side rank; one core and one interface per block row
    b = [rng.randn(sb, n, sb) for _ in range(3)]
    bl, br = [rng.randn(sb, rl) for _ in range(3)], [rng.randn(sb, rr) for _ in range(3)]
    zbl, zbr = [rng.randn(sb, rz) for _ in range(3)], [rng.randn(sb, rz1) for _ in range(3)]
    x_k, z_k = rng.randn(*x_shape), rng.randn(*z_shape)
    if direction == "bck":
        x_nb, z_nb = rng.randn(2, n, rl), rng.randn(2, n, rz)
    else:
        x_nb, z_nb = rng.randn(rr, n, 2), rng.randn(rz1, n, 2)
    return (pl, A, pr, bl, b, br, zl, zr, zbl, zbr, x_k, x_nb, z_k, z_nb)


def _fix_gauge(core, other, direction):
    """Fix the sign of every basis vector of a split (``core`` holds them
    as rows for bck, as columns for fwd; ``other`` carries the inverse
    sign on the shared bond): largest entry positive."""
    if direction == "bck":
        flat = core.reshape(core.shape[0], -1)
        sgn = np.sign(flat[np.arange(flat.shape[0]), np.abs(flat).argmax(axis=1)])
        return core * sgn[:, None, None], other * sgn
    flat = core.reshape(-1, core.shape[-1])
    sgn = np.sign(flat[np.abs(flat).argmax(axis=0), np.arange(flat.shape[1])])
    return core * sgn, other * sgn[:, None, None, None]


@pytest.mark.parametrize("direction", ["bck", "fwd"])
def test_split_steps_match_jax_and_the_untransposed_call(direction, monkeypatch):
    """A split step with enrichment (the K3 call site) gives the cores of
    the JAX package's ``make_sweep_steps`` on the same numpy inputs, and
    bit for bit those of a K3 that hands back q for the caller to transpose."""
    from ttipm_tpu.solvers.fused_algebra import make_sweep_steps
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    ops = _split_operands(np.random.RandomState(30), direction)

    def solve_np(pl, A, pr, bl, b, br, x, ineq=False):
        return 0.5 * x + 0.1 * np.roll(x, 1, axis=2), None, 0.0, 0.0, 0.0

    def solve_t(pl, A, pr, bl, b, br, x):  # a batch of one: the block axis is 2 of (1, ...)
        z = x.new_zeros(x.shape[0])
        return 0.5 * x + 0.1 * torch.roll(x, 1, dims=3), z, z, z

    steps = make_sweep_steps(
        _jax_algebra(), np.einsum, np, solve_np,
        lambda mat: np.linalg.svd(mat, full_matrices=False), np.linalg.qr,
        np.ascontiguousarray, lambda ref: 0.0)
    jstep = steps.bck_split_step if direction == "bck" else steps.fwd_split_step
    want = jstep(*ops, False, 2, 2, True)

    def tt(v):
        if isinstance(v, dict):
            return _torch_dict(v)
        return [torch.as_tensor(t) for t in v] if isinstance(v, list) else torch.as_tensor(v)

    tstep = fb.bck_split_step if direction == "bck" else fb.fwd_split_step
    K.reset_counts()
    got = tstep(solve_t, *b1([tt(v) for v in ops]), 2, 2, True)
    assert K.STATS["panel_qr"].plain_calls == 1

    def old_panel_qr(a, transposed=False):
        q, r = torch.linalg.qr(a, mode="reduced")
        return (q.T if transposed else q), r

    monkeypatch.setattr(fb.kernels, "panel_qr", old_panel_qr)
    old = tstep(solve_t, *b1([tt(v) for v in ops]), 2, 2, True)
    for g, o in zip(got[:8], old[:8]):
        if isinstance(g, dict):
            assert all(torch.equal(g[k], o[k]) for k in g)
        elif isinstance(g, (list, tuple)):
            assert all(torch.equal(x, y) for x, y in zip(g, o))
        else:
            assert torch.equal(g, o)

    width = 4  # r_out + kick
    assert tuple(got[0].shape) == ((1, width, 4, 4) if direction == "bck" else (1, 3, 4, width))
    for ci, ni in ((0, 1), (2, 3)):  # (x core, x neighbour), (z core, z neighbour)
        gc, gn = _fix_gauge(got[ci][0].numpy(), got[ni][0].numpy(), direction)
        wc, wn = _fix_gauge(np.asarray(want[ci]), np.asarray(want[ni]), direction)
        np.testing.assert_allclose(gc, wc, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gn, wn, rtol=1e-12, atol=1e-12 * np.abs(wn).max())
