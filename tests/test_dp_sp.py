"""dp x sp composition: Ensemble(space_axis=...) shards members over one
mesh axis AND every member's grid over another (full 2-D mesh layout for
sweeps whose grids exceed one chip's HBM).  The trajectories must match the
single-chip Ensemble to within the controller tolerance (SURVEY.md §2:
DP x SP row; reference has no counterpart — its sweeps are one process per
pickled model, user_guide.rst:125-138)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from triflow_jax import Model, schemes
from triflow_jax.parallel import Ensemble


def mesh_2d(ne=2, ns=4):
    devices = np.array(jax.devices()[: ne * ns]).reshape(ne, ns)
    return Mesh(devices, ("ensemble", "space"))


@pytest.fixture(scope="module")
def burgers():
    return Model("k * dxxU - U * dxU", "U", "k")


def _sweep(model, N=256, B=4, seed=0):
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.RandomState(seed)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + phi) for phi in rng.rand(B)])
    ks = np.linspace(0.5, 2.0, B)
    pars = [dict(k=float(k), periodic=True) for k in ks]
    return x, u0, pars


# adaptive runs agree to within the controller tolerance (the sharded F is
# last-ulp different from the wrap-indexed single-chip F — different but
# equally valid dt sequences); fixed-dt runs share the exact dt sequence, so
# only the accumulated ulp noise separates them
@pytest.mark.parametrize("scheme,kw,atol", [
    (schemes.RODASPR, dict(tol=1e-6), 2e-6),
    (schemes.ROS2, dict(), 1e-11),
    (schemes.DOPRI5, dict(tol=1e-7), 2e-7),
    (schemes.Theta, dict(theta=1.0), 1e-11),
])
def test_dp_sp_matches_single_chip(burgers, scheme, kw, atol):
    x, u0, pars = _sweep(burgers)
    ref = Ensemble(burgers, u0, pars, x, scheme=scheme, **kw)
    t_ref, u_ref = ref.run(tmax=0.5, dt=0.125)

    ens = Ensemble(burgers, u0, pars, x, scheme=scheme, mesh=mesh_2d(),
                   space_axis="space", **kw)
    t, u = ens.run(tmax=0.5, dt=0.125)
    assert t == pytest.approx(t_ref)
    assert np.allclose(np.asarray(u), np.asarray(u_ref),
                       rtol=1e-9, atol=atol)
    # state must stay laid out over the whole 2-D mesh
    assert len(ens.u.sharding.device_set) == 8


def test_dp_sp_scanned_steps(burgers):
    """steps(n, dt) scans the dp x sp stepper in one device call."""
    x, u0, pars = _sweep(burgers)
    ref = Ensemble(burgers, u0, pars, x, scheme=schemes.RODASPR, tol=1e-6)
    ref.run(tmax=0.5, dt=0.125)

    ens = Ensemble(burgers, u0, pars, x, scheme=schemes.RODASPR, tol=1e-6,
                   mesh=mesh_2d(), space_axis="space")
    t, u = ens.steps(4, 0.125)
    assert t == pytest.approx(0.5)
    assert np.allclose(np.asarray(u), np.asarray(ref.u),
                       rtol=1e-9, atol=2e-6)


def test_dp_sp_nonperiodic(burgers):
    """Edge (non-periodic) closure through the sharded SPIKE step with a
    member axis: the global-boundary band folding must land only on the
    space-edge shards of every member row."""
    N, B = 256, 2
    x = np.linspace(0, 10, N)
    u0 = np.stack([np.cos(2 * np.pi * x / 10),
                   np.sin(2 * np.pi * x / 10)])
    pars = [dict(k=0.7, periodic=False), dict(k=1.3, periodic=False)]
    ref = Ensemble(burgers, u0, pars, x, scheme=schemes.RODASPR, tol=1e-6)
    t_ref, u_ref = ref.run(tmax=0.25, dt=0.125)

    ens = Ensemble(burgers, u0, pars, x, scheme=schemes.RODASPR, tol=1e-6,
                   mesh=mesh_2d(), space_axis="space")
    t, u = ens.run(tmax=0.25, dt=0.125)
    assert np.allclose(np.asarray(u), np.asarray(u_ref),
                       rtol=1e-9, atol=2e-6)


def test_dp_sp_guards(burgers):
    x, u0, pars = _sweep(burgers, B=4)
    with pytest.raises(ValueError, match="space_axis requires a mesh"):
        Ensemble(burgers, u0, pars, x, space_axis="space")
    x3, u3, p3 = _sweep(burgers, B=3)
    with pytest.raises(ValueError, match="must divide"):
        Ensemble(burgers, u3, p3, x3, mesh=mesh_2d(), space_axis="space")


def test_dp_sp_dirichlet_hook():
    """Hooks in dp x sp mode: the reference-style Dirichlet hook (README
    config 1) applies per member on the GLOBAL sharded state — the edge
    scatters land on the owning space shards of every member row, matching
    the single-chip ensemble bit-for-bit up to accumulated ulp noise
    (fixed dt: identical step sequences)."""
    model = Model("k * dxxU - c * dxU", "U", ["k", "c"])
    N, B = 256, 4
    x = np.linspace(0, 1, N)
    rng = np.random.RandomState(1)
    u0 = np.stack([np.cos(2 * np.pi * x * 5 + p) for p in rng.rand(B)])
    pars = [dict(k=1e-3 * (i + 1), c=3e-3, periodic=False)
            for i in range(B)]

    def dirichlet(t, fields, pars):
        fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
        return fields, pars

    kw = dict(scheme=schemes.Theta, theta=1.0, hook=dirichlet)
    ref = Ensemble(model, u0, pars, x, **kw)
    t_ref, u_ref = ref.run(tmax=25.0, dt=1.0)

    ens = Ensemble(model, u0, pars, x, mesh=mesh_2d(), space_axis="space",
                   **kw)
    t, u = ens.run(tmax=25.0, dt=1.0)
    U = np.asarray(u)
    assert U[:, 0, 0] == pytest.approx(1.0)
    assert np.allclose(U, np.asarray(u_ref), rtol=1e-9, atol=1e-11)


@pytest.mark.slow
def test_dp_sp_per_member_dt(burgers):
    """per_member_dt in dp x sp mode: member-local clocks/steps drive the
    masked controller on per-member errors (each pmax-reduced over its
    space shards).  Attempt counts must be heterogeneous across a
    heterogeneous sweep and the trajectories match the single-chip
    per-member ensemble to within the controller tolerance."""
    N, B = 256, 4
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10)] * B)
    ks = [3e-3, 3e-2, 0.3, 3.0]           # ~3 decades of stiffness
    pars = [dict(k=float(k), periodic=True) for k in ks]
    kw = dict(scheme=schemes.RODASPR, tol=1e-5, per_member_dt=True)

    ref = Ensemble(burgers, u0, pars, x, **kw)
    ref.run(tmax=1.0, dt=0.5)

    ens = Ensemble(burgers, u0, pars, x, mesh=mesh_2d(), space_axis="space",
                   **kw)
    t, u = ens.run(tmax=1.0, dt=0.5)
    assert t == pytest.approx(1.0)
    assert np.allclose(np.asarray(u), np.asarray(ref.u),
                       rtol=1e-6, atol=2e-5)
    iters = np.asarray(ens.member_iters)
    assert iters.min() >= 1 and iters.max() > iters.min()
    # per-member attempt counts agree with the single-chip controller
    assert np.all(np.abs(iters - np.asarray(ref.member_iters)) <= 2)


@pytest.mark.slow
def test_dp_sp_df64(burgers):
    """df64 members on the 2-D mesh: DF state shards over BOTH axes, the
    shard-mapped df64 cores run mixed-precision stage solves, and the
    result lands in the single-chip df64 ensemble's accuracy class (well
    below anything f32 could produce)."""
    model = Model("k * dxxU - U * dxU", "U", "k", double="df64")
    x, u0, pars = _sweep(model)
    ref = Ensemble(model, u0, pars, x, scheme=schemes.ROS2)
    _t, u_ref = ref.run(tmax=0.25, dt=0.125)

    ens = Ensemble(model, u0, pars, x, scheme=schemes.ROS2, mesh=mesh_2d(),
                   space_axis="space")
    t, u = ens.run(tmax=0.25, dt=0.125)
    assert t == pytest.approx(0.25)
    # mixed sharded solves vs full-df64 single-chip solves: agreement far
    # below the f32 envelope (~1e-6) proves real double-float physics
    assert np.abs(u.to_float64() - u_ref.to_float64()).max() < 1e-10
    assert len(ens.u.hi.sharding.device_set) == 8
