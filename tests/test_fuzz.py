"""Randomized-model fuzzing of the oracle triangle.

The reference's test strategy hand-picks a few analytic models
(upstream tests/test_model.py, SURVEY.md §4); this suite generates a
seeded stream of random PDE systems — random variable counts, derivative
orders, nonlinear products, per-node vs scalar parameters, both BC modes —
and closes the triangle on every one of them:

    jax-compiled F  ==  numpy-compiled F          (cross-backend)
    symbolic banded J ==  brute-force FD Jacobian (diff_approx oracle)
    sparse J         ==  dense J                  (layout consistency)

Every case is deterministic (seed-parametrized) so failures reproduce.
"""

import numpy as np
import pytest

from triflow_jax import Model


# whole-module slow tier: the oracle-equivalence / physics
# workloads are minutes-long on the virtual CPU mesh (CI fast lane skips
# them; the full matrix runs nightly)
pytestmark = pytest.mark.slow


VARS = ["u", "v", "w"]
PARS = ["a", "b", "c"]


def _random_term(rng, nvar, max_order):
    """One additive term: optional parameter coefficient times a product of
    (possibly differentiated, possibly squared) fields."""
    factors = []
    par = PARS[rng.randint(len(PARS))]
    nfac = rng.randint(1, 3)  # 1 or 2 field factors
    for _ in range(nfac):
        var = VARS[rng.randint(nvar)]
        order = rng.randint(0, max_order + 1)
        tok = var if order == 0 else "d" + "x" * order + var
        if rng.rand() < 0.25 and order == 0:
            tok = f"{tok}**2"
        factors.append(tok)
    sign = "-" if rng.rand() < 0.5 else ""
    return sign + par + " * " + " * ".join(factors)


def _random_system(seed):
    rng = np.random.RandomState(seed)
    nvar = rng.randint(1, 4)
    max_order = int(rng.choice([1, 2, 3, 4]))
    eqs = [
        " + ".join(
            _random_term(rng, nvar, max_order) for _ in range(rng.randint(1, 4))
        )
        for _ in range(nvar)
    ]
    return eqs, VARS[:nvar], rng


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_oracle_triangle(seed):
    eqs, dep_vars, rng = _random_system(seed)
    periodic = bool(rng.rand() < 0.5)
    N = 48

    m_jax = Model(eqs, dep_vars, PARS, compiler="jax")
    m_np = Model(eqs, dep_vars, PARS, compiler="numpy")

    x, _dx = np.linspace(0.0, 10.0, N, retstep=True, endpoint=False)
    fields_kw = {
        var: 0.8 * np.cos((i + 1) * x * 2 * np.pi / 10.0) + 1.5
        for i, var in enumerate(dep_vars)
    }
    fields_jax = m_jax.fields_template(x=x, **fields_kw)
    fields_np = m_np.fields_template(x=x, **fields_kw)
    # mix scalar and per-node parameters
    parameters = dict(periodic=periodic)
    for i, p in enumerate(PARS):
        val = 0.1 + 0.5 * rng.rand()
        parameters[p] = val if i % 2 == 0 else np.full(N, val)

    F_jax = np.asarray(m_jax.F(fields_jax, parameters), dtype=float)
    F_np = np.asarray(m_np.F(fields_np, parameters), dtype=float)
    scale = max(1.0, np.abs(F_np).max())
    assert np.allclose(F_jax, F_np, rtol=1e-8, atol=1e-8 * scale), (
        f"cross-backend F mismatch for {eqs} (periodic={periodic})"
    )

    J_dense = np.asarray(m_jax.J(fields_jax, parameters, sparse=False))
    J_sparse = m_jax.J(fields_jax, parameters).todense()
    J_np = np.asarray(m_np.J(fields_np, parameters, sparse=False))
    J_approx = m_jax.F.diff_approx(fields_jax, parameters)
    jscale = max(1.0, np.abs(J_approx).max())
    assert np.allclose(J_sparse, J_dense, rtol=1e-10, atol=1e-10 * jscale)
    # exact oracle: the two symbolic backends must agree to fp precision
    assert np.allclose(J_np, J_dense, rtol=1e-8, atol=1e-8 * jscale), (
        f"cross-backend J mismatch for {eqs} (periodic={periodic})"
    )
    # FD oracle: loose, dominated by finite-difference truncation of the
    # brute-force Jacobian (the reference uses the same 1e-2 tolerance,
    # upstream tests/test_model.py:49-50)
    assert np.allclose(J_approx, J_dense, rtol=1e-2, atol=1e-3 * jscale), (
        f"symbolic-vs-FD Jacobian mismatch for {eqs} (periodic={periodic})"
    )


@pytest.mark.parametrize("seed", [3, 7])
def test_fuzz_theta_step_finite(seed):
    """A random stiff system survives one implicit theta step without
    producing non-finite values (solver robustness on arbitrary banded
    structure, not just the curated workloads)."""
    from triflow_jax import schemes

    eqs, dep_vars, rng = _random_system(seed)
    m = Model(eqs, dep_vars, PARS, compiler="jax")
    N = 48
    x = np.linspace(0.0, 10.0, N, endpoint=False)
    fields = m.fields_template(
        x=x,
        **{
            var: 0.5 * np.cos((i + 1) * x * 2 * np.pi / 10.0) + 1.5
            for i, var in enumerate(dep_vars)
        },
    )
    parameters = dict(periodic=True)
    for p in PARS:
        parameters[p] = 0.05 + 0.1 * rng.rand()
    scheme = schemes.Theta(m, theta=1.0)
    t, fields2 = scheme(0.0, fields, 1e-3, parameters)
    for var in dep_vars:
        assert np.isfinite(np.asarray(fields2[var])).all()
