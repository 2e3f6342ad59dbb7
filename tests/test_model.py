"""Model-layer tests: the oracle triangle (compiled F vs np.gradient; symbolic
J vs brute-force FD J vs dense J), API contract, upwind smoke, pickling —
mirroring the reference test strategy
(upstream tests/test_model.py, see SURVEY.md §4)."""

import numpy as np
import pytest

from triflow_jax import Model
from triflow_jax.core.symbolic import centered_stencil_coefficients


@pytest.fixture
def heat_model():
    return Model(
        differential_equations="k * dxxT", dependent_variables="T", parameters="k"
    )


@pytest.mark.parametrize(
    "func",
    np.array([[expr, [expr]] for expr in ["k * dxxU", "k * dx(dxU)"]], dtype=object)
    .flatten()
    .tolist(),
)
@pytest.mark.parametrize("var", [func("U") for func in (str, list)])
@pytest.mark.parametrize("par", [func("k") for func in (str, list)])
@pytest.mark.parametrize("k", [1, np.ones((100,))])
@pytest.mark.parametrize("compiler", ["numpy", "jax"])
def test_model_monovariate(func, var, par, k, compiler):
    model = Model(func, var, par, compiler=compiler)
    x, dx = np.linspace(0, 10, 100, retstep=True, endpoint=False)
    U = np.cos(x * 2 * np.pi / 10)
    fields = model.fields_template(x=x, U=U)
    parameters = dict(periodic=True, k=k)
    F = model.F(fields, parameters)
    J_sparse = model.J(fields, parameters)
    J_dense = model.J(fields, parameters, sparse=False)
    J_approx = model.F.diff_approx(fields, parameters)

    dxU = np.gradient(np.pad(U, 2, mode="wrap")) / dx
    dxxU = np.gradient(dxU) / dx
    dxxU = dxxU[2:-2]

    assert np.isclose(F, k * dxxU, rtol=1e-2).all()
    assert np.isclose(J_approx, J_sparse.todense(), rtol=1e-2, atol=1e-9).all()
    assert np.isclose(J_approx, J_dense, rtol=1e-2, atol=1e-9).all()


def test_model_bivariate():
    model = Model(["k1 * dxx(v)", "k2 * dxx(u)"], ["u", "v"], ["k1", "k2"])
    x, dx = np.linspace(0, 10, 50, retstep=True, endpoint=False)
    u = np.cos(x * 2 * np.pi / 10)
    v = np.sin(x * 2 * np.pi / 10)
    fields = model.fields_template(x=x, u=u, v=v)
    parameters = dict(periodic=True, k1=1, k2=1)
    F = model.F(fields, parameters)
    J_sparse = model.J(fields, parameters)
    J_dense = model.J(fields, parameters, sparse=False)
    J_approx = model.F.diff_approx(fields, parameters)

    dxu = np.gradient(np.pad(u, 2, mode="wrap")) / dx
    dxxu = np.gradient(dxu) / dx
    dxxu = dxxu[2:-2]
    dxv = np.gradient(np.pad(v, 2, mode="wrap")) / dx
    dxxv = np.gradient(dxv) / dx
    dxxv = dxxv[2:-2]

    assert np.isclose(F, np.vstack([dxxv, dxxu]).flatten("F"), rtol=1e-2).all()
    assert np.isclose(J_approx, J_sparse.todense(), rtol=1e-4, atol=1e-9).all()
    assert np.isclose(J_approx, J_dense, rtol=1e-4, atol=1e-9).all()


@pytest.mark.parametrize(
    "args",
    [
        ("dxU", lambda x: -np.sin(x)),
        ("dxxU", lambda x: -np.cos(x)),
        ("dxxxU", lambda x: np.sin(x)),
        ("dxxxxU", lambda x: np.cos(x)),
    ],
)
def test_finite_diff_against_analytic(args):
    symb_diff, analytical_func = args
    model = Model(symb_diff, "U")
    x = np.linspace(0, 2 * np.pi, 1000, endpoint=False)
    fields = model.fields_template(x=x, U=np.cos(x))
    out = model.F(fields, dict(periodic=True))
    assert np.isclose(out, analytical_func(x), rtol=1e-2, atol=1e-4).all()


def test_stencil_coefficients_match_reference():
    """The generated weights must equal the reference's hand-written stencils
    (upstream triflow/core/model.py:401-439)."""
    import sympy as sp

    half = sp.Rational(1, 2)
    assert centered_stencil_coefficients(1, 1) == {-1: -half, 1: half}
    assert centered_stencil_coefficients(2, 1) == {-1: 1, 0: -2, 1: 1}
    assert centered_stencil_coefficients(3, 2) == {-2: -half, -1: 1, 1: -1, 2: half}
    assert centered_stencil_coefficients(4, 2) == {-2: 1, -1: -4, 0: 6, 1: -4, 2: 1}


def test_jac_simpl():
    model = Model("dxxU", "U")
    model_simp = Model("dxxU", "U", simplify=True)
    x = np.linspace(0, 2 * np.pi, 50, endpoint=False)
    U = np.cos(x)
    assert np.isclose(
        model.J(model.fields_template(x=x, U=U), dict(periodic=True)).todense(),
        model_simp.J(model_simp.fields_template(x=x, U=U), dict(periodic=True)).todense(),
    ).all()


def test_jac_fdiff_approx():
    model = Model("dxxU", "U")
    model_approx = Model("dxxU", "U", fdiff_jac=True)
    x = np.linspace(0, 2 * np.pi, 50, endpoint=False)
    U = np.cos(x)
    assert np.isclose(
        model.J(model.fields_template(x=x, U=U), dict(periodic=True)).todense(),
        model_approx.J(
            model_approx.fields_template(x=x, U=U), dict(periodic=True)
        ).todense(),
    ).all()


@pytest.mark.parametrize("compiler", ["numpy", "jax"])
@pytest.mark.parametrize("periodic", [True, False])
def test_model_api(compiler, periodic):
    model = Model(
        differential_equations=["k * dxxU + s"],
        dependent_variables="U",
        parameters="k",
        help_functions="s",
        compiler=compiler,
    )
    assert set(model._args) == set(
        ["x", "U_m1", "U", "U_p1", "s_m1", "s", "s_p1", "k", "dx"]
    )
    with pytest.raises(NotImplementedError):
        Model("dxxxxxU", "U")
    with pytest.raises(ValueError):
        Model("dxxx(dx)", "U")
    # stray symbols fail fast: a token past the order-9 namespace and an
    # undeclared parameter are both unknown symbols, not silent no-ops
    with pytest.raises(ValueError):
        Model("dxxxxxxxxxxU", "U")
    with pytest.raises(ValueError):
        Model("k * dxxU + q", "U", "k")
    x, dx = np.linspace(0, 10, 100, retstep=True, endpoint=False)
    U = np.cos(x * 2 * np.pi / 10)
    s = np.zeros_like(x)
    fields = model.fields_template(x=x, U=U, s=s)
    parameters = dict(periodic=periodic, k=1)
    model.F(fields, parameters)
    model.J(fields, parameters)


def test_functional_form_with_order():
    """``dx(U, n)`` functional form: the explicit order wins over the
    token's order (docstring contract of generate_sympify_namespace)."""
    x = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    m_tok = Model("k * dxxU", "U", "k")
    m_fun = Model("k * dx(U, 2)", "U", "k")
    fields_tok = m_tok.fields_template(x=x, U=np.cos(x))
    fields_fun = m_fun.fields_template(x=x, U=np.cos(x))
    pars = dict(k=1.0, periodic=True)
    assert np.allclose(np.asarray(m_tok.F(fields_tok, pars)),
                       np.asarray(m_fun.F(fields_fun, pars)))
    # beyond the centered library without high_order -> NotImplementedError
    with pytest.raises(NotImplementedError):
        Model("dx(U, 12)", "U")


def test_high_order_extension():
    """Beyond-reference capability: arbitrary-order stencils behind the
    high_order opt-in."""
    model = Model("dxxxxxxU", "U", high_order=True)
    assert model.halo == 3
    x = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    fields = model.fields_template(x=x, U=np.cos(x))
    out = model.F(fields, dict(periodic=True))
    assert np.isclose(out, -np.cos(x), rtol=1e-2, atol=1e-3).all()


@pytest.mark.parametrize("compiler", ["numpy", "jax"])
@pytest.mark.parametrize("uporder", [1, 2, 3])
@pytest.mark.parametrize("vel", ["1", "U"])
@pytest.mark.parametrize("periodic", [True, False])
def test_upwind(compiler, uporder, vel, periodic):
    model = Model(
        differential_equations=["upwind(%s, U, %i)" % (vel, uporder)],
        dependent_variables="U",
        parameters="k",
        help_functions="s",
        compiler=compiler,
    )
    x, dx = np.linspace(0, 10, 100, retstep=True, endpoint=False)
    U = np.cos(x * 2 * np.pi / 10)
    s = np.zeros_like(x)
    fields = model.fields_template(x=x, U=U, s=s)
    parameters = dict(periodic=periodic, k=1)
    model.F(fields, parameters)
    model.J(fields, parameters)


def test_upwind_advection_accuracy():
    """Constant positive velocity: upwind flux must equal the backward
    difference of a smooth field to truncation accuracy."""
    model = Model("-upwind(c, U, 1)", "U", "c")
    x = np.linspace(0, 2 * np.pi, 2000, endpoint=False)
    fields = model.fields_template(x=x, U=np.cos(x))
    out = model.F(fields, dict(periodic=True, c=1.0))
    assert np.isclose(out, np.sin(x), rtol=1e-2, atol=1e-2).all()


def test_backend_equivalence():
    """jax and numpy backends must agree to float64 roundoff."""
    for eq, vars_, pars in [
        ("k * dxxU - U * dxU", "U", ["k"]),
        (["-dxxzeta - dxxxxzeta + (dxzeta)**2"], ["zeta"], []),
    ]:
        m_jax = Model(eq, vars_, pars, compiler="jax")
        m_np = Model(eq, vars_, pars, compiler="numpy")
        x = np.linspace(0, 10, 128, endpoint=False)
        rng = np.random.RandomState(0)
        values = {v: rng.randn(128) for v in m_jax._dep_vars}
        f_jax = m_jax.fields_template(x=x, **values)
        f_np = m_np.fields_template(x=x, **values)
        p = {k: 0.5 for k in pars}
        for periodic in (True, False):
            p["periodic"] = periodic
            assert np.allclose(
                m_jax.F(f_jax, p), m_np.F(f_np, p), rtol=1e-12, atol=1e-12
            )
            assert np.allclose(
                m_jax.J(f_jax, p).todense(),
                m_np.J(f_np, p).todense(),
                rtol=1e-12,
                atol=1e-12,
            )


def test_save_load(heat_model, tmp_path):
    heat_model.save(str(tmp_path / "heat_model"))
    loaded = Model.load(str(tmp_path / "heat_model"))

    x, dx = np.linspace(0, 10, 50, retstep=True, endpoint=False)
    T = np.cos(x * 2 * np.pi / 10)
    initial_fields = heat_model.fields_template(x=x, T=T)
    parameters = dict(periodic=True, k=1)

    assert (loaded.F_array == heat_model.F_array).all()
    assert (loaded.J_array == heat_model.J_array).all()
    assert (loaded._J_sparse_array == heat_model._J_sparse_array).all()
    assert loaded._args == heat_model._args
    assert (
        loaded.F(initial_fields, parameters) == heat_model.F(initial_fields, parameters)
    ).all()
    assert (
        loaded.J(initial_fields, parameters).todense()
        == heat_model.J(initial_fields, parameters).todense()
    ).all()
