"""Simulation-level integration tests, mirroring
upstream tests/test_simulation.py: heat equation under every scheme
with physics-limit assertions, Dirichlet-hook convergence, RuntimeError
guards, repr/rerun/no-tmax/progress smoke, post-process pipeline — plus
accuracy checks against the analytic solution and a scipy oracle."""

import functools as ft

import numpy as np
import pytest

from triflow_jax import Model, Simulation, schemes


@pytest.fixture(scope="module")
def heat_model():
    return Model(differential_equations="k * dxxT",
                 dependent_variables="T",
                 parameters="k")


def make_fields(model, N=50):
    x = np.linspace(0, 10, N, endpoint=False)
    T = np.cos(x * 2 * np.pi / 10)
    return model.fields_template(x=x, T=T)


@pytest.mark.parametrize(
    "scheme,tol",
    [(schemes.ROS2, 1e-1), (schemes.ROS3PRL, 1e-1), (schemes.ROS3PRw, 1e-1),
     (schemes.RODASPR, 1e-1), (schemes.Theta, 1e-1),
     # the scipy proxies step through the host Fortran loop 100 output
     # times — ~40s each, nightly tier (the fast lane keeps scipy_ode
     # coverage via test_scipy_ode_proxy / the oracle cross-checks)
     pytest.param(schemes.scipy_ode, 1e-1, marks=pytest.mark.slow),
     pytest.param(
         ft.partial(schemes.scipy_ode, integrator="vode", method="bdf"),
         1e-1, marks=pytest.mark.slow),
     # explicit pairs need a tighter tol on this stiff target: at loose tol
     # the controller tolerates a marginally-damped Nyquist mode of
     # amplitude ~ tol (the classic explicit-on-stiff behavior)
     (schemes.DOPRI5, 1e-4), (schemes.BS32, 1e-4)],
)
def test_simul_heat_eq(heat_model, scheme, tol):
    initial_fields = make_fields(heat_model)
    parameters = dict(periodic=True, k=1)
    for i, (t, fields) in enumerate(
        Simulation(heat_model, initial_fields, parameters, scheme=scheme,
                   dt=1, tmax=100, tol=tol)
    ):
        continue
    assert t == 100
    assert np.isclose(float(np.asarray(fields["T"]).mean()), 0, atol=1e-8)
    # the cosine mode decays as exp(-omega^2 k t): essentially zero at t=100
    assert np.abs(np.asarray(fields["T"])).max() < 1e-4


def test_heat_eq_matches_analytic(heat_model):
    """Accuracy: the discrete cosine mode decays at the *discrete* rate
    lambda = (2 - 2 cos(omega dx)) / dx^2; a tight-tolerance adaptive RODASPR
    run must match to high precision."""
    N = 64
    x, dx = np.linspace(0, 10, N, retstep=True, endpoint=False)
    omega = 2 * np.pi / 10
    initial = heat_model.fields_template(x=x, T=np.cos(omega * x))
    tmax = 2.0
    simul = Simulation(heat_model, initial, dict(periodic=True, k=1),
                       dt=0.5, tmax=tmax, tol=1e-10)
    for t, fields in simul:
        pass
    lam = (2 - 2 * np.cos(omega * dx)) / dx ** 2
    expected = np.cos(omega * x) * np.exp(-lam * tmax)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=1e-6)


def test_nonlinear_matches_scipy_oracle():
    """Trajectory cross-validation on Burgers: device RODASPR vs scipy vode
    at tight tolerance (the BASELINE 1e-8 matching strategy, SURVEY.md §4)."""
    model = Model("k * dxxU - U * dxU", "U", "k")
    N = 128
    x = np.linspace(0, 10, N, endpoint=False)
    U0 = np.cos(x * 2 * np.pi / 10)
    pars = dict(periodic=True, k=0.5)
    tmax = 1.0

    simul = Simulation(model, model.fields_template(x=x, U=U0), dict(pars),
                       dt=0.25, tmax=tmax, tol=1e-9)
    for t, fields in simul:
        pass
    U_row = np.asarray(fields["U"])

    oracle = Simulation(model, model.fields_template(x=x, U=U0), dict(pars),
                        scheme=schemes.scipy_ode, time_stepping=False,
                        dt=0.25, tmax=tmax, atol=1e-12, rtol=1e-12)
    for t, fields in oracle:
        pass
    U_ref = np.asarray(fields["U"])
    assert np.allclose(U_row, U_ref, atol=1e-8)


@pytest.mark.parametrize("scheme",
                         [schemes.ROS3PRL, schemes.ROS3PRw, schemes.RODASPR])
def test_simul_heat_eq_dirichlet(heat_model, scheme):
    initial_fields = make_fields(heat_model)
    parameters = dict(periodic=False, k=1)

    def dirichlet_bdc(t, fields, parameters):
        fields["T"] = fields["T"].at[0].set(1.0).at[-1].set(1.0)
        return fields, parameters

    simul = Simulation(heat_model, initial_fields, parameters,
                       hook=dirichlet_bdc, scheme=scheme,
                       dt=.5, tmax=100, tol=1e-1)
    for i, (t, fields) in enumerate(simul):
        pass
    assert np.isclose(t, 100)
    assert np.isclose(np.asarray(fields["T"]), 1, atol=1e-1).all()


def test_simul_runtime_error(heat_model):
    initial_fields = make_fields(heat_model)
    parameters = dict(periodic=True, k=1)

    simul = Simulation(heat_model, initial_fields, parameters,
                       dt=1, tol=1e-1, max_iter=2, tmax=10)
    with pytest.raises(RuntimeError):
        for t, fields in simul:
            pass
    assert simul.status == "failed"

    simul = Simulation(heat_model, initial_fields, parameters,
                       dt=1, tol=1e-10, dt_min=.1, tmax=10)
    with pytest.raises(RuntimeError):
        for t, fields in simul:
            pass


def test_simul_repr(heat_model):
    initial_fields = make_fields(heat_model)
    simul = Simulation(heat_model, initial_fields, dict(periodic=True, k=1),
                       dt=1, tol=1e-1, tmax=10)
    str(simul)
    str(simul.timer)


def test_simul_already_ended(heat_model):
    initial_fields = make_fields(heat_model)
    simul = Simulation(heat_model, initial_fields, dict(periodic=True, k=1),
                       dt=1, tol=1e-1, tmax=10)
    simul.run(progress=False)
    with pytest.warns(UserWarning):
        simul.run(progress=False)


def test_simul_no_tmax(heat_model):
    initial_fields = make_fields(heat_model)
    simul = Simulation(heat_model, initial_fields, dict(periodic=True, k=1),
                       dt=1, tol=1e-1)
    next(simul)


@pytest.mark.parametrize("progress", [True, False])
def test_simul_progress(heat_model, progress):
    initial_fields = make_fields(heat_model)
    simul = Simulation(heat_model, initial_fields, dict(periodic=True, k=1),
                       dt=1, tol=1e-1, tmax=3)
    simul.run(progress=progress)
    assert simul.t == 3


def test_simul_pprocess(heat_model):
    initial_fields = make_fields(heat_model)
    simul = Simulation(heat_model, initial_fields, dict(periodic=True, k=1),
                       dt=1, tol=1e-1, tmax=10)

    seen = []

    def probe_energy(simul):
        seen.append(float(np.square(np.asarray(simul.fields["T"])).sum()))
        return simul

    simul.add_post_process("energy", probe_energy)
    simul.run(progress=False)
    simul.remove_post_process("energy")
    assert simul.post_processes == []
    assert len(seen) == 11  # registration call + 10 steps
    assert seen[-1] < seen[0]


def test_hook_time_dependent(heat_model):
    """Time-dependent boundary values must be traced correctly."""
    import jax.numpy as jnp

    initial_fields = make_fields(heat_model)

    def bdc(t, fields, pars):
        fields["T"] = fields["T"].at[0].set(jnp.sin(t))
        return fields, pars

    simul = Simulation(heat_model, initial_fields, dict(periodic=False, k=1),
                       hook=bdc, dt=0.5, tmax=2, tol=1e-6)
    for t, fields in simul:
        pass
    assert np.isclose(float(np.asarray(fields["T"])[0]), np.sin(2), atol=1e-8)


def test_wave_system_two_vars():
    """Coupled 2-variable system (wave equation, BASELINE config)."""
    model = Model(["c**2 * dxxu", "v"], ["v", "u"], ["c"])
    N = 100
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.exp(-((x - 5) ** 2))
    v0 = np.zeros_like(x)
    fields = model.fields_template(x=x, v=v0, u=u0)
    simul = Simulation(model, fields, dict(periodic=True, c=1.0),
                       dt=0.2, tmax=2, tol=1e-6)
    for t, fields in simul:
        pass
    # energy (integral of u) is conserved for periodic wave equation
    assert np.isclose(
        np.asarray(fields["u"]).sum(), u0.sum(), rtol=1e-6
    )
    assert np.abs(np.asarray(fields["u"])).max() > 0.1


def test_run_device_chunk_matches_stepwise(heat_model):
    """run(device_chunk=n) scans n output steps per device call; the
    trajectory, step count and stream emissions must match the stepwise
    run exactly."""
    initial = make_fields(heat_model)
    pars = dict(k=1.0, periodic=True)

    sim_a = Simulation(heat_model, initial.copy(), pars, dt=0.5, tmax=5.2,
                       tol=1e-2)
    seen_a = []
    sim_a.stream.sink(lambda s: seen_a.append(float(s.t)))
    ta, fa = sim_a.run(progress=False)

    sim_b = Simulation(heat_model, initial.copy(), pars, dt=0.5, tmax=5.2,
                       tol=1e-2)
    seen_b = []
    sim_b.stream.sink(lambda s: seen_b.append(float(s.t)))
    tb, fb = sim_b.run(progress=False, device_chunk=4)

    assert np.isclose(ta, tb)
    assert sim_a.i == sim_b.i
    assert np.allclose(seen_a, seen_b)
    assert np.allclose(np.asarray(fa["T"]), np.asarray(fb["T"]),
                       rtol=1e-10, atol=1e-12)
    assert sim_b.status == "finished"


def test_run_device_chunk_hook_tail(heat_model):
    """Regression: after the chunked loop the state is bulk-fetched host
    arrays; the stepwise tail (tmax not a multiple of dt) applies the hook
    host-side and relies on jax .at[...] semantics — the driver must
    restore device arrays before it."""
    initial = make_fields(heat_model)
    pars = dict(k=1.0, periodic=False)

    def dirichlet(t, fields, parameters):
        fields["T"] = fields["T"].at[0].set(1.0).at[-1].set(1.0)
        return fields, parameters

    kw = dict(hook=dirichlet, dt=1.0, tmax=6.5, tol=1e-2)
    sim_a = Simulation(heat_model, initial.copy(), dict(pars), **kw)
    ta, fa = sim_a.run(progress=False)
    sim_b = Simulation(heat_model, initial.copy(), dict(pars), **kw)
    tb, fb = sim_b.run(progress=False, device_chunk=4)
    assert np.isclose(ta, tb)
    assert np.asarray(fb["T"])[0] == pytest.approx(1.0)
    assert np.allclose(np.asarray(fa["T"]), np.asarray(fb["T"]),
                       rtol=1e-10, atol=1e-12)


def test_device_time_stepping_theta(heat_model):
    """The universal step-doubling wrapper runs as ONE device-resident
    lax.while_loop per output step (VERDICT r1: the host-loop formulation
    paid m+1 dispatches per accepted internal step), with the controller
    matching the analytic decay at tight tolerance."""
    from triflow_jax.core.schemes import DeviceTimeStepping

    N = 64
    x, dx = np.linspace(0, 10, N, retstep=True, endpoint=False)
    omega = 2 * np.pi / 10
    initial = heat_model.fields_template(x=x, T=np.cos(omega * x))
    simul = Simulation(heat_model, initial, dict(periodic=True, k=1),
                       dt=1.0, tmax=4.0, scheme=schemes.Theta, theta=0.5,
                       time_stepping=True, tol=1e-7)
    assert isinstance(simul._scheme, DeviceTimeStepping)
    for t, fields in simul:
        pass
    assert t == 4.0
    # the controller carried its adapted internal dt across output steps
    assert simul._scheme._internal_dt is not None
    assert simul._scheme._internal_iter >= 1
    lam = (2 - 2 * np.cos(omega * dx)) / dx ** 2
    expected = np.cos(omega * x) * np.exp(-lam * 4.0)
    assert np.allclose(np.asarray(fields["T"]), expected, atol=1e-4)


@pytest.mark.slow
def test_device_time_stepping_large_grid(heat_model):
    """Adaptive Theta at production-ish N steps in a handful of device
    calls (the round-1 host wrapper was unusable at this size)."""
    import time

    N = 100_000
    x = np.linspace(0, 10, N, endpoint=False)
    omega = 2 * np.pi / 10
    initial = heat_model.fields_template(x=x, T=np.cos(omega * x))
    simul = Simulation(heat_model, initial, dict(periodic=True, k=1),
                       dt=0.5, tmax=1.0, scheme=schemes.Theta, theta=0.5,
                       time_stepping=True, tol=1e-4)
    simul.run(progress=False)  # compile + run
    start = time.monotonic()
    simul2 = Simulation(heat_model, initial, dict(periodic=True, k=1),
                        dt=0.5, tmax=1.0, scheme=schemes.Theta, theta=0.5,
                        time_stepping=True, tol=1e-4)
    simul2.run(progress=False)
    elapsed = time.monotonic() - start
    assert simul2.t == 1.0
    assert elapsed < 30.0  # the round-1 host loop took minutes here
