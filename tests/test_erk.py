"""Explicit embedded Runge-Kutta family (ERK_general / RK4 / BS32 / DOPRI5)
— the device-resident replacement for the reference's explicit scipy_ode
integrators (reference schemes.py:430-499): accuracy against the discrete
analytic solution, controller behavior, failure guards, ensemble/vmap
composition."""

import numpy as np
import pytest

from triflow_jax import Model, Simulation, schemes


@pytest.fixture(scope="module")
def heat_model():
    return Model("k * dxxT", "T", "k")


def heat_setup(model, N=64):
    x, dx = np.linspace(0, 10, N, retstep=True, endpoint=False)
    omega = 2 * np.pi / 10
    fields = model.fields_template(x=x, T=np.cos(omega * x))
    lam = (2 - 2 * np.cos(omega * dx)) / dx ** 2
    return x, omega, lam, fields


@pytest.mark.parametrize("scheme_cls", [schemes.DOPRI5, schemes.BS32])
def test_adaptive_erk_matches_discrete_analytic(heat_model, scheme_cls):
    """The discrete cosine mode decays at lambda = (2-2cos(w dx))/dx^2; a
    tight-tolerance adaptive explicit run must track it."""
    x, omega, lam, fields = heat_setup(heat_model)
    scheme = scheme_cls(heat_model, tol=1e-8)
    pars = dict(periodic=True, k=1.0)
    t, tmax = 0.0, 1.0
    while t < tmax - 1e-12:
        t, fields = scheme(t, fields, 0.25, pars)
    expected = np.cos(omega * x) * np.exp(-lam * tmax)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=5e-5)
    # the controller adapted: many internal steps ran inside few dispatches
    assert scheme._internal_iter > 1
    assert scheme._internal_dt > 0


def test_rk4_fixed_step_accuracy(heat_model):
    """Classic RK4 under the explicit stability limit matches the discrete
    decay rate closely (4th-order time error is negligible at dt ~ dx^2/5)."""
    x, omega, lam, fields = heat_setup(heat_model)
    scheme = schemes.RK4(heat_model)
    pars = dict(periodic=True, k=1.0)
    dt = 5e-3  # lambda_max = 4/dx^2 ~ 163 -> dt < 2.78/163 ~ 1.7e-2
    t = 0.0
    for _ in range(200):
        t, fields = scheme(t, fields, dt, pars)
    expected = np.cos(omega * x) * np.exp(-lam * t)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=1e-6)


def test_erk_simulation_integration(heat_model):
    """DOPRI5 through the Simulation driver: no double-wrapping (built-in
    controller), physics limit reached."""
    N = 50
    x = np.linspace(0, 10, N, endpoint=False)
    fields = heat_model.fields_template(x=x, T=np.cos(x * 2 * np.pi / 10))
    simul = Simulation(heat_model, fields, dict(periodic=True, k=1),
                       scheme=schemes.DOPRI5, dt=1, tmax=20, tol=1e-4)
    # built-in controller recognized: not wrapped in DeviceTimeStepping
    assert isinstance(simul._scheme, schemes.ERK_general)
    for t, fields in simul:
        pass
    assert t == 20
    assert np.abs(np.asarray(fields["T"])).max() < 2e-2


def test_erk_max_iter_guard(heat_model):
    """A stiff target with a tiny iteration budget must surface status 1 as
    the same RuntimeError idiom as the ROW controller."""
    x, _omega, _lam, fields = heat_setup(heat_model, N=128)
    scheme = schemes.DOPRI5(heat_model, tol=1e-10, max_iter=3)
    with pytest.raises(RuntimeError, match="max iterations"):
        scheme(0.0, fields, 10.0, dict(periodic=True, k=1.0))


def test_erk_dt_min_guard():
    """A blowing-up problem (err -> inf, dt -> floor) surfaces status 2."""
    model = Model("U**2", "U")
    x = np.linspace(0, 1, 32, endpoint=False)
    fields = model.fields_template(x=x, U=np.full(32, 50.0))
    scheme = schemes.BS32(model, tol=1e-8, dt_min=1e-3)
    with pytest.raises(RuntimeError, match="less than authorized"):
        scheme(0.0, fields, 5.0, dict(periodic=True))


def test_dt_min_healthy_problem_does_not_trip(heat_model):
    """Regression: the first-call internal-dt seed must respect dt_min —
    a seed below the floor can never grow past it (10x/accept cap) and
    used to trip the dt-floor status code on a perfectly healthy run."""
    x, omega, lam, fields = heat_setup(heat_model)
    scheme = schemes.DOPRI5(heat_model, tol=1e-6, dt_min=1e-4)
    t, fields = scheme(0.0, fields, 0.25, dict(periodic=True, k=1.0))
    assert t == 0.25
    expected = np.cos(omega * x) * np.exp(-lam * t)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=1e-4)


def test_interpolate_mode_keeps_internal_dt_unclamped(heat_model):
    """Regression: with recompute_target=False the adapted internal dt must
    not be re-clamped to the output dt at every output step — that is the
    documented point of the mode."""
    x, _omega, _lam, fields = heat_setup(heat_model)
    scheme = schemes.DOPRI5(heat_model, tol=1e-3, recompute_target=False)
    pars = dict(periodic=True, k=1.0)
    t = 0.0
    for _ in range(30):            # tiny output dt << adapted internal dt
        t, fields = scheme(t, fields, 1e-3, pars)
    assert scheme._internal_dt > 5e-3
    assert scheme._internal_iter == 1  # one overshooting attempt per call


def test_erk_ctor_validation(heat_model):
    with pytest.raises(ValueError, match="requires a tolerance"):
        schemes.ERK_general(heat_model, np.zeros((2, 2)), [0.5, 0.5],
                            b_pred=[1.0, 0.0], time_stepping=True, tol=None)
    with pytest.raises(NotImplementedError, match="predictor"):
        schemes.ERK_general(heat_model, np.zeros((2, 2)), [0.5, 0.5],
                            time_stepping=True, tol=1e-3)


def test_erk_ensemble(heat_model):
    """DOPRI5 composes with the ensemble layer (vmap over members)."""
    from triflow_jax.parallel import Ensemble

    N, B = 64, 3
    x = np.linspace(0, 10, N, endpoint=False)
    omega = 2 * np.pi / 10
    amps = np.linspace(0.5, 1.5, B)
    u0 = (amps[:, None] * np.cos(omega * x)[None]).astype(np.float64)
    ens = Ensemble(heat_model, u0, dict(periodic=True, k=1.0), x,
                   scheme=schemes.DOPRI5, tol=1e-8)
    ens.run(0.5, 0.25)
    dx = x[1] - x[0]
    lam = (2 - 2 * np.cos(omega * dx)) / dx ** 2
    expected = amps[:, None] * np.cos(omega * x)[None] * np.exp(-lam * 0.5)
    assert np.allclose(np.asarray(ens.u)[:, 0], expected, atol=5e-5)


@pytest.mark.parametrize("scheme_cls", [schemes.DOPRI5, schemes.BS32])
def test_fsal_matches_generic_loop(scheme_cls):
    """The FSAL-carrying adaptive loop (null hook) must be bit-equal to the
    generic loop (forced here via an identity but non-null hook)."""
    model = Model("k * dxxU - U * dxU", "U", "k")
    N = 128
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(2 * np.pi * x / 10) + 0.1 * np.sin(4 * np.pi * x / 10)
    pars = dict(periodic=True, k=0.05)

    def ident(t, fields, p):
        return fields, p

    sf, sg = scheme_cls(model, tol=1e-7), scheme_cls(model, tol=1e-7)
    tf = tg = 0.0
    ff = model.fields_template(x=x, U=u0)
    fg = model.fields_template(x=x, U=u0)
    for _ in range(6):
        tf, ff = sf(tf, ff, 0.125, pars)
        tg, fg = sg(tg, fg, 0.125, pars, hook=ident)
    assert sf._internal_iter == sg._internal_iter
    assert np.abs(np.asarray(ff["U"]) - np.asarray(fg["U"])).max() < 1e-12


@pytest.mark.parametrize("scheme_cls,kw", [
    (schemes.RODASPR, dict(time_stepping=True, tol=1e-8)),
    (schemes.DOPRI5, dict(tol=1e-8)),
])
def test_recompute_target_false_interpolates(heat_model, scheme_cls, kw):
    """recompute_target=False (reference schemes.py:213-227): internal steps
    overshoot the output time and the returned state is linearly
    interpolated — accuracy degrades to O(dt_i^2) but stays controlled."""
    x, omega, lam, fields = heat_setup(heat_model, N=128)
    sch = scheme_cls(heat_model, recompute_target=False, **kw)
    pars = dict(periodic=True, k=1.0)
    t = 0.0
    for _ in range(4):
        t, fields = sch(t, fields, 0.25, pars)
    expected = np.cos(omega * x) * np.exp(-lam * t)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=5e-4)


def test_rk4_universal_time_stepping(heat_model):
    """RK4 has no embedded pair: Simulation must wrap it in the Richardson
    step-doubling controller (DeviceTimeStepping), which drives it through
    _fixed_step_fn."""
    N = 50
    x = np.linspace(0, 10, N, endpoint=False)
    fields = heat_model.fields_template(x=x, T=np.cos(x * 2 * np.pi / 10))
    simul = Simulation(heat_model, fields, dict(periodic=True, k=1),
                       scheme=schemes.RK4, dt=0.05, tmax=2.0,
                       time_stepping=True, tol=1e-4)
    assert isinstance(simul._scheme, schemes.DeviceTimeStepping)
    for t, fields in simul:
        pass
    assert t == 2.0
    omega = 2 * np.pi / 10
    dx = x[1] - x[0]
    lam = (2 - 2 * np.cos(omega * dx)) / dx ** 2
    expected = np.cos(omega * x) * np.exp(-lam * 2.0)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=1e-3)


def test_erk_per_member_dt(heat_model):
    """Explicit schemes compose with the per-member adaptive machinery:
    each member's internal clock follows its own stability/accuracy limit
    (dt ~ 1/k for explicit diffusion), so iteration counts spread with
    stiffness."""
    from triflow_jax.parallel import Ensemble

    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    omega = 2 * np.pi / 10
    u0 = np.cos(omega * x)
    dx = x[1] - x[0]
    ks = [0.05, 2.0]
    pars = [dict(k=k, periodic=True) for k in ks]
    ens = Ensemble(heat_model, np.tile(u0, (2, 1)), pars, x,
                   scheme=schemes.DOPRI5, tol=1e-6, per_member_dt=True)
    t, u = ens.step(0.5)
    assert t == pytest.approx(0.5)
    iters = ens.member_iters
    assert iters[0] < iters[1]  # stiffer member needs more attempts
    for i, k in enumerate(ks):
        lam = k * (2 - 2 * np.cos(omega * dx)) / dx ** 2
        expected = np.cos(omega * x) * np.exp(-lam * 0.5)
        assert np.allclose(np.asarray(u)[i, 0], expected, atol=1e-4)


def test_erk_hook_dirichlet(heat_model):
    """Dirichlet hook traced inside the adaptive explicit loop."""
    N = 50
    x = np.linspace(0, 10, N, endpoint=False)
    fields = heat_model.fields_template(x=x, T=np.cos(x * 2 * np.pi / 10))

    def dirichlet(t, flds, pars):
        flds["T"] = flds["T"].at[0].set(1.0).at[-1].set(1.0)
        return flds, pars

    simul = Simulation(heat_model, fields, dict(periodic=False, k=1),
                       hook=dirichlet, scheme=schemes.BS32,
                       dt=0.5, tmax=30, tol=1e-3)
    for t, fields in simul:
        pass
    assert np.isclose(np.asarray(fields["T"]), 1, atol=1e-1).all()
