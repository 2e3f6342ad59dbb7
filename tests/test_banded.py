"""Banded linear-algebra kernels vs scipy oracles.

The reference delegates these solves to SuperLU (schemes.py:148-163, 553-557);
here we verify the device-resident PCR / chunked-SPIKE + Woodbury path against
scipy sparse LU on random diagonally-dominant systems and on real model
Jacobians."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla

from triflow_jax import Model
from triflow_jax.core.compiler import bands_to_csc
from triflow_jax.ops.banded import (
    axpy_bands,
    banded_matvec,
    factor_banded,
    identity_bands,
    solve_banded,
)


def random_bands(W, nvar, N, seed=0, dominance=3.0):
    """Random banded matrix made diagonally dominant (guarantees the
    pivoting-free BCR is stable, like I - gamma*dt*J for moderate dt)."""
    rng = np.random.RandomState(seed)
    bands = rng.randn(W, nvar, nvar, N)
    h = W // 2
    for m in range(nvar):
        bands[h, m, m] += dominance * W * nvar
    return bands


@pytest.mark.parametrize("W,nvar,N", [
    (3, 1, 64), (3, 1, 63), (5, 1, 64), (5, 1, 101),
    (3, 2, 50), (5, 2, 64), (5, 2, 37), (5, 3, 40), (1, 2, 16),
])
@pytest.mark.parametrize("periodic", [True, False])
def test_solve_vs_scipy(W, nvar, N, periodic):
    bands = random_bands(W, nvar, N)
    A = bands_to_csc(bands, periodic)
    rng = np.random.RandomState(1)
    rhs = rng.randn(nvar, N)
    # scipy oracle works in the interleaved node-major flat ordering
    b_flat = rhs.T.flatten()
    x_ref = spla.spsolve(A.tocsc(), b_flat)
    x = solve_banded(bands, rhs, periodic)
    x_flat = np.asarray(x).T.flatten()
    assert np.allclose(x_flat, x_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("periodic", [True, False])
def test_matvec_vs_scipy(periodic):
    W, nvar, N = 5, 2, 48
    bands = random_bands(W, nvar, N)
    A = bands_to_csc(bands, periodic)
    rng = np.random.RandomState(2)
    u = rng.randn(nvar, N)
    out = banded_matvec(bands, u, periodic)
    ref = (A @ u.T.flatten()).reshape(N, nvar).T
    assert np.allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)


def test_factor_reuse_multiple_rhs():
    """One factorization must serve many solves (ROW stage pattern)."""
    bands = random_bands(5, 1, 80)
    fact = factor_banded(bands, periodic=True)
    A = bands_to_csc(bands, True)
    rng = np.random.RandomState(3)
    for i in range(4):
        rhs = rng.randn(1, 80)
        x = fact.solve(rhs)
        ref = spla.spsolve(A, rhs.flatten())
        assert np.allclose(np.asarray(x).flatten(), ref, rtol=1e-9, atol=1e-9)


def test_axpy_and_identity():
    W, nvar, N = 5, 2, 32
    bands = random_bands(W, nvar, N)
    eye = identity_bands(W, nvar, N)
    A = axpy_bands(1.0, -0.25, bands)
    dense_eye = bands_to_csc(np.asarray(eye), False).todense()
    assert np.allclose(dense_eye, np.eye(nvar * N))
    dense_A = bands_to_csc(np.asarray(A), False).todense()
    dense_ref = np.eye(nvar * N) - 0.25 * bands_to_csc(bands, False).todense()
    assert np.allclose(dense_A, dense_ref)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("eq,varnames,pars,pvals", [
    ("k * dxxU", ["U"], ["k"], {"k": 1.0}),
    ("-dxxU - dxxxxU - U * dxU", ["U"], [], {}),
    (["c**2 * dxxu", "v"], ["v", "u"], ["c"], {"c": 0.7}),
])
def test_implicit_system_solve_on_model_jacobian(periodic, eq, varnames, pars, pvals):
    """Solve (I - gamma*dt*J) x = F exactly as the implicit schemes do, and
    compare against scipy on the CSC form of the same system."""
    model = Model(eq, varnames, pars)
    N = 70
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.RandomState(4)
    fields = model.fields_template(
        x=x, **{v: rng.randn(N) * 0.1 + np.cos(x) for v in varnames}
    )
    p = dict(pvals, periodic=periodic)
    u, helpers, xg = model.backend.split_fields(fields)
    pstack = model.backend.pack_pars(p, xg)
    J_bands = model.backend.J_bands(u, helpers, pstack, xg, periodic=periodic)
    F = model.backend.F(u, helpers, pstack, xg, periodic=periodic)

    dt, gamma = 0.01, 0.25
    A_bands = axpy_bands(1.0, -gamma * dt, J_bands)
    sol = solve_banded(A_bands, F, periodic)

    J_csc = bands_to_csc(np.asarray(J_bands), periodic)
    A_csc = sps.identity(N * len(varnames), format="csc") - gamma * dt * J_csc
    ref = spla.spsolve(A_csc, np.asarray(F).T.flatten())
    assert np.allclose(np.asarray(sol).T.flatten(), ref, rtol=1e-8, atol=1e-10)


def test_batched_solve_matches_loop():
    """vmap over a leading ensemble axis must equal per-member solves."""
    import jax

    # B=3 matches no other axis (2P = 4 Woodbury columns here), so a
    # batch/column axis mix-up cannot pass unnoticed
    W, nvar, N, B = 5, 1, 32, 3
    bands = np.stack([random_bands(W, nvar, N, seed=s) for s in range(B)])
    rhs = np.random.RandomState(7).randn(B, nvar, N)
    batched = jax.vmap(lambda b, r: solve_banded(b, r, True))(bands, rhs)
    for i in range(B):
        single = solve_banded(bands[i], rhs[i], True)
        assert np.allclose(np.asarray(batched[i]), np.asarray(single), rtol=1e-10)


def test_jit_compatible():
    import jax

    bands = random_bands(5, 2, 64)
    rhs = np.random.RandomState(8).randn(2, 64)

    @jax.jit
    def run(b, r):
        return solve_banded(b, r, True)

    out = run(bands, rhs)
    ref = solve_banded(bands, rhs, True)
    assert np.allclose(np.asarray(out), np.asarray(ref))
