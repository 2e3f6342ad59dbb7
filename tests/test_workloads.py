"""BASELINE workload regression tests (BASELINE.json configs): each reference
workload integrated through the public API with physics assertions and, where
cheap, a tight-tolerance scipy-oracle trajectory match (the 1e-8 strategy of
SURVEY.md §4)."""

import pytest
import numpy as np

from triflow_jax import Model, Simulation, schemes


# whole-module slow tier: the oracle-equivalence / physics
# workloads are minutes-long on the virtual CPU mesh (CI fast lane skips
# them; the full matrix runs nightly)
pytestmark = pytest.mark.slow



def test_ks_trajectory_matches_scipy_oracle():
    """Config 3: stiff KS with adaptive ROS stepper vs scipy vode at tight
    rtol — trajectories must agree to 1e-8 over a chaotic transient."""
    model = Model("-dxxU - dxxxxU - U * dxU", "U")
    N = 128
    x = np.arange(N) * 0.5
    U0 = np.cos(0.2 * x) + 0.05 * np.cos(0.4 * x)
    pars = dict(periodic=True)
    tmax = 1.0

    simul = Simulation(model, model.fields_template(x=x, U=U0), dict(pars),
                       dt=0.5, tmax=tmax, tol=1e-12)
    for t, fields in simul:
        pass
    U_row = np.asarray(fields["U"])

    oracle = Simulation(model, model.fields_template(x=x, U=U0), dict(pars),
                        scheme=schemes.scipy_ode, time_stepping=False,
                        dt=0.5, tmax=tmax, atol=1e-13, rtol=1e-13, nsteps=50000)
    for t, fields in oracle:
        pass
    assert np.allclose(U_row, np.asarray(fields["U"]), atol=1e-8)


def test_falling_film_mass_conservation():
    """Config 4: coupled h/q falling film (block-banded J, upwind) — exact
    discrete mass conservation of the height under periodic BC."""
    model = Model(
        ["-dxq",
         "9/7 * q**2 / h**2 * dxh - upwind(17/7 * q / h, q, 2)"
         " + (h - q / h**2) / delta"],
        ["h", "q"], ["delta"],
    )
    assert model._nvar == 2
    assert model.halo == 2  # upwind accuracy 2 stencil
    N = 256
    x = np.linspace(0, 100, N, endpoint=False)
    h = 1 + 0.1 * np.cos(2 * np.pi * x / 100 * 3)
    q = h ** 3 / 3
    simul = Simulation(model, model.fields_template(x=x, h=h, q=q),
                       dict(periodic=True, delta=0.3),
                       dt=0.5, tmax=5, tol=1e-6)
    for t, fields in simul:
        pass
    hf = np.asarray(fields["h"])
    assert np.isfinite(hf).all()
    assert abs(hf.mean() - h.mean()) < 1e-12
    assert hf.min() > 0  # film never dewets


def test_burgers_kdv_soliton_speed():
    """Burgers-KdV: the dispersive term must radiate (non-symmetric tail)."""
    model = Model("-U * dxU + a * dxxU + b * dxxxU", "U", ["a", "b"])
    N = 256
    x = np.linspace(-10, 10, N, endpoint=False)
    U0 = np.exp(-x ** 2)
    simul = Simulation(model, model.fields_template(x=x, U=U0),
                       dict(periodic=True, a=0.05, b=0.2),
                       dt=0.5, tmax=3, tol=1e-8)
    for t, fields in simul:
        pass
    U = np.asarray(fields["U"])
    left, right = U[: N // 2], U[N // 2:]
    assert not np.allclose(left[::-1], right, atol=1e-3)  # asymmetric
    assert np.isclose(U.sum(), U0.sum(), rtol=1e-9)       # mass conserved


def test_thin_film_droplet_positivity():
    model = Model(
        "dx((h**3 + h**2) * dx(-sigma * dxxh + alpha * (1 / h**3 - e / h**4)))",
        "h", ["sigma", "alpha", "e"],
    )
    N = 128
    x = np.linspace(0, 10, N, endpoint=False)
    # precursor at the disjoining-pressure equilibrium (h* = e) so the film
    # spreads without rupturing
    h = np.maximum(0.1, 1 - ((x - 5) / 2) ** 2)
    simul = Simulation(model, model.fields_template(x=x, h=h),
                       dict(periodic=False, alpha=0.05, sigma=10, e=0.1),
                       dt=0.02, tmax=0.2, tol=1e-4)
    for t, fields in simul:
        pass
    hf = np.asarray(fields["h"])
    assert np.isfinite(hf).all()
    assert hf.min() > 0


def test_wave_system_matches_discrete_dispersion():
    """Wave-equation system (reference wave_equation.ipynb: dtv = c^2 dxxu,
    dtu = v): a single Fourier mode of the DISCRETIZED operator oscillates
    at omega_d = c * k_d with k_d^2 = (2 - 2 cos(k dx)) / dx^2 — the
    trajectory must match that analytic solution to time-integration
    tolerance, and the discrete energy must be conserved."""
    model = Model(["c**2 * dxxu", "v"], ["v", "u"], "c")
    assert model._nvar == 2
    N, L, c = 128, 10.0, 1.3
    x = np.linspace(0, L, N, endpoint=False)
    dx = x[1] - x[0]
    k = 2 * np.pi / L
    u0 = np.sin(k * x)
    v0 = np.zeros(N)
    simul = Simulation(model, model.fields_template(x=x, u=u0, v=v0),
                       dict(periodic=True, c=c), dt=0.25, tmax=2.0,
                       tol=1e-10)
    energies = []
    for t, fields in simul:
        v = np.asarray(fields["v"])
        u = np.asarray(fields["u"])
        # the discrete energy conserved by the 3-point dxx semi-discretization
        # uses FORWARD differences (centered np.gradient oscillates at
        # O((k dx)^2) even on the exact solution)
        du = (np.roll(u, -1) - u) / dx
        energies.append(0.5 * np.sum(v ** 2 + c ** 2 * du ** 2))
    kd = np.sqrt((2 - 2 * np.cos(k * dx))) / dx
    omega = c * kd
    u_exact = np.sin(k * x) * np.cos(omega * t)
    v_exact = -omega * np.sin(k * x) * np.sin(omega * t)
    assert np.allclose(np.asarray(fields["u"]), u_exact, atol=1e-6)
    assert np.allclose(np.asarray(fields["v"]), v_exact, atol=1e-6)
    e = np.asarray(energies)
    assert np.abs(e - e[0]).max() < 1e-4 * e[0]


def test_so_wavy_coupled_pair_oracle_and_symmetry():
    """Coupled convection pair (reference so_wavy.ipynb): cross-advected
    U/V with shared diffusion.  The system is symmetric under U<->V swap,
    and the adaptive ROW trajectory must match scipy vode at tight rtol."""
    model = Model(["k * dxxU - c * U * dxV", "k * dxxV - c * V * dxU"],
                  ["U", "V"], ["k", "c"])
    N, L = 128, 10.0
    x = np.linspace(0, L, N, endpoint=False)
    U0 = 1 + 0.3 * np.cos(2 * np.pi * x / L)
    V0 = 1 + 0.3 * np.sin(2 * np.pi * x / L)
    pars = dict(periodic=True, k=0.05, c=1.0)
    tmax = 1.0

    simul = Simulation(model, model.fields_template(x=x, U=U0, V=V0),
                       dict(pars), dt=0.5, tmax=tmax, tol=1e-12)
    for t, fields in simul:
        pass
    U_row, V_row = np.asarray(fields["U"]), np.asarray(fields["V"])

    oracle = Simulation(model, model.fields_template(x=x, U=U0, V=V0),
                        dict(pars), scheme=schemes.scipy_ode,
                        time_stepping=False, dt=0.5, tmax=tmax,
                        atol=1e-13, rtol=1e-13, nsteps=50000)
    for t, fields in oracle:
        pass
    assert np.allclose(U_row, np.asarray(fields["U"]), atol=1e-8)
    assert np.allclose(V_row, np.asarray(fields["V"]), atol=1e-8)

    # U<->V swap symmetry: swapping the initial fields swaps the solution
    swapped = Simulation(model, model.fields_template(x=x, U=V0, V=U0),
                         dict(pars), dt=0.5, tmax=tmax, tol=1e-12)
    for t, fields in swapped:
        pass
    assert np.allclose(np.asarray(fields["U"]), V_row, atol=1e-9)
    assert np.allclose(np.asarray(fields["V"]), U_row, atol=1e-9)


def test_duck_typed_manual_model():
    """Hand-written model (no symbolic layer): object with .F and
    fields_template stepping through scipy_ode (reference manual-2D path)."""
    from triflow_jax import factory

    class Decay:
        fields_template = factory(("x",), [("u", ("x",))], [])

        @staticmethod
        def F(fields, pars):
            return -pars["lam"] * np.asarray(fields["u"])

    model = Decay()
    x = np.linspace(0, 1, 16)
    fields = model.fields_template(x=x, u=np.ones(16))
    simul = Simulation(model, fields, {"lam": 2.0}, dt=0.25, tmax=1.0,
                       scheme=schemes.scipy_ode, time_stepping=False)
    for t, fields in simul:
        pass
    assert np.allclose(np.asarray(fields["u"]), np.exp(-2.0), atol=1e-6)
