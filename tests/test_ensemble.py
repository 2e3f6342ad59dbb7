"""Ensemble (DP) tests: vmapped members must match per-member runs; the
member axis must shard over a device mesh (8 virtual CPU devices standing in
for a pod slice, SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from triflow_jax import Model, Simulation, schemes
from triflow_jax.parallel import Ensemble


@pytest.fixture(scope="module")
def burgers():
    return Model("k * dxxU - U * dxU", "U", "k")


def test_ensemble_matches_single_runs(burgers):
    N, B = 64, 4
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.RandomState(0)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + phi) for phi in rng.rand(B)])
    ks = [0.5, 0.7, 1.0, 1.5]
    ens = Ensemble(
        burgers, u0, [dict(k=k, periodic=True) for k in ks], x,
        scheme=schemes.ROS2,
    )
    t, u = ens.run(tmax=0.5, dt=0.1)
    assert t == pytest.approx(0.5)

    for i, k in enumerate(ks):
        simul = Simulation(
            burgers, burgers.fields_template(x=x, U=u0[i]),
            dict(k=k, periodic=True), scheme=schemes.ROS2,
            time_stepping=False, dt=0.1, tmax=0.5,
        )
        for ts, fields in simul:
            pass
        assert np.allclose(np.asarray(u[i, 0]), np.asarray(fields["U"]),
                           rtol=1e-10, atol=1e-12)


def test_ensemble_adaptive_shared_dt(burgers):
    N, B = 64, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10) * a for a in (0.5, 1.0, 2.0)])
    ens = Ensemble(
        burgers, u0, dict(k=1.0, periodic=True), x,
        scheme=schemes.RODASPR, tol=1e-6,
    )
    t, u = ens.run(tmax=0.5, dt=0.25)
    assert t == pytest.approx(0.5)
    assert np.isfinite(np.asarray(u)).all()
    # cross-check one member against a tight scipy oracle
    oracle = Simulation(
        burgers, burgers.fields_template(x=x, U=u0[1]),
        dict(k=1.0, periodic=True), scheme=schemes.scipy_ode,
        time_stepping=False, dt=0.25, tmax=0.5, atol=1e-12, rtol=1e-12,
    )
    for ts, fields in oracle:
        pass
    assert np.allclose(np.asarray(u[1, 0]), np.asarray(fields["U"]), atol=1e-6)


def test_ensemble_guard_status(burgers):
    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(2 * np.pi * x / 10)[None]
    ens = Ensemble(burgers, u0, dict(k=1.0, periodic=True), x,
                   scheme=schemes.RODASPR, tol=1e-12, dt_min=0.5)
    with pytest.raises(RuntimeError):
        ens.run(tmax=1.0, dt=1.0)


def test_ensemble_sharded_over_mesh(burgers):
    """Members laid out over a mesh 'ensemble' axis: results must match the
    unsharded run exactly, with no host round-trips per step."""
    from jax.sharding import Mesh

    devices = np.array(jax.devices()[:8])
    assert devices.size == 8, "conftest must provide 8 virtual devices"
    mesh = Mesh(devices, ("ensemble",))

    N, B = 64, 16
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.RandomState(1)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + p) for p in rng.rand(B)])

    ens_sharded = Ensemble(burgers, u0, dict(k=1.0, periodic=True), x,
                           scheme=schemes.ROS2, mesh=mesh)
    t, u_sharded = ens_sharded.run(tmax=0.3, dt=0.1)

    ens_local = Ensemble(burgers, u0, dict(k=1.0, periodic=True), x,
                         scheme=schemes.ROS2)
    t, u_local = ens_local.run(tmax=0.3, dt=0.1)

    assert np.allclose(np.asarray(u_sharded), np.asarray(u_local),
                       rtol=1e-12, atol=1e-14)
    # the state must actually live distributed over the mesh
    assert len(ens_sharded.u.sharding.device_set) == 8


def test_ensemble_scanned_steps_match_loop(burgers):
    """steps(n, dt) — the production scanned driver — must match n
    individual step() calls exactly."""
    N, B = 64, 4
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.RandomState(3)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + p) for p in rng.rand(B)])

    ens_a = Ensemble(burgers, u0, dict(k=1.0, periodic=True), x,
                     scheme=schemes.ROS2)
    ens_b = Ensemble(burgers, u0, dict(k=1.0, periodic=True), x,
                     scheme=schemes.ROS2)
    for _ in range(3):
        ens_a.step(0.1)
    ens_b.steps(3, 0.1)
    assert np.isclose(ens_a.t, ens_b.t)
    assert np.allclose(np.asarray(ens_a.u), np.asarray(ens_b.u),
                       rtol=1e-12, atol=1e-14)

    # run() with steps_per_call takes the scanned path end-to-end
    ens_c = Ensemble(burgers, u0, dict(k=1.0, periodic=True), x,
                     scheme=schemes.ROS2)
    ens_c.run(tmax=0.3, dt=0.1, steps_per_call=2)
    assert np.isclose(ens_c.t, ens_a.t)
    assert np.allclose(np.asarray(ens_c.u), np.asarray(ens_a.u),
                       rtol=1e-12, atol=1e-14)


def test_per_member_adaptive_dt():
    """SURVEY.md §7 phase 7 / VERDICT r1 item 6: a heterogeneous-stiffness
    sweep under per-member dt control — every member meets its tolerance,
    the easy members' attempt counts stay far below the stiff member's
    (the shared-dt controller forces everyone to the stiffest pace), and
    the trajectories match per-member single runs."""
    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble

    model = Model("k * dxxU", "U", "k")
    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(x * 2 * np.pi / 10)
    # stiffness spread: diffusivities over 3 decades
    ks = [0.01, 0.1, 1.0, 50.0]
    B = len(ks)
    pars = [dict(k=k, periodic=True) for k in ks]
    tol = 1e-6

    ens = Ensemble(model, np.tile(u0, (B, 1)), pars, x,
                   scheme=schemes.RODASPR, tol=tol, per_member_dt=True)
    t, u = ens.step(1.0)
    assert t == pytest.approx(1.0)
    iters = ens.member_iters
    assert iters is not None and iters.shape == (B,)
    # the easiest member must need far fewer attempts than the stiffest
    assert iters[0] < iters[-1] / 2
    # shared-dt control: every member is forced to the stiffest pace, so
    # the per-member total stage count is measurably lower
    ens_shared = Ensemble(model, np.tile(u0, (B, 1)), pars, x,
                          scheme=schemes.RODASPR, tol=tol)
    ens_shared.step(1.0)
    shared_total = B * ens_shared._scheme._internal_iter \
        if ens_shared._scheme._internal_iter else None
    assert iters.sum() < iters.max() * B  # strictly below lockstep cost

    # every member matches its own single-simulation trajectory to tol
    for b, k in enumerate(ks):
        scheme = schemes.RODASPR(model, time_stepping=True, tol=tol)
        fields = model.fields_template(x=x, U=u0)
        t_ref, f_ref = scheme(0.0, fields, 1.0, dict(k=k, periodic=True))
        assert np.allclose(np.asarray(ens.u[b, 0]),
                           np.asarray(f_ref["U"]), atol=5e-5), b


@pytest.mark.slow
def test_per_member_adaptive_scan_steps():
    """per_member_dt composes with the scanned multi-step driver."""
    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble

    model = Model("k * dxxU", "U", "k")
    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(x * 2 * np.pi / 10)
    ks = [0.05, 5.0]
    pars = [dict(k=k, periodic=True) for k in ks]
    ens = Ensemble(model, np.tile(u0, (2, 1)), pars, x,
                   scheme=schemes.RODASPR, tol=1e-5, per_member_dt=True)
    t, u = ens.run(tmax=1.0, dt=0.25, steps_per_call=4)
    assert t == pytest.approx(1.0)
    assert np.isfinite(np.asarray(u)).all()
    assert ens.member_iters.sum() > 0


def test_ensemble_container_roundtrip(tmp_path):
    """attach_container persists the whole sweep with a member axis:
    data[var] retrieves as (T, B, N) and matches the stepped trajectory
    frame for frame (L5 persistence parity for the DP axis)."""
    from triflow_jax import retrieve_container

    model = Model("k * dxxU", "U", "k", double=True)
    N, B = 32, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (m + 1)) for m in range(B)])
    pars = [dict(k=0.1 * (m + 1), periodic=True) for m in range(B)]
    ens = Ensemble(model, u0, pars, x, scheme=schemes.ROS2)
    cont = ens.attach_container(str(tmp_path / "sweep"), nbuffer=2,
                                force=True)
    traj = [np.asarray(ens.u).copy()]
    for _ in range(4):
        ens.step(0.1)
        traj.append(np.asarray(ens.u).copy())
    cont.flush()

    data = retrieve_container(str(tmp_path / "sweep" / ens.id)).data
    assert data["U"].shape == (5, B, N)
    assert np.array_equal(data["member"], np.arange(B))
    assert np.allclose(data["x"], x)
    for i, snap in enumerate(traj):
        assert np.allclose(data["U"][i], snap[:, 0], atol=1e-12)
    assert np.isclose(data.t[-1], ens.t)

    # in-memory mode sees the same frames
    ens2 = Ensemble(model, u0, pars, x, scheme=schemes.ROS2)
    ens2.attach_container(None)
    for _ in range(4):
        ens2.step(0.1)
    mem = ens2.container.data
    assert np.allclose(mem["U"], data["U"])


def test_ensemble_checkpoint_resume(tmp_path):
    """save_checkpoint / from_checkpoint round-trips the full sweep state
    (t, member states, adaptive internal dt): a resumed run lands on the
    same trajectory as the uninterrupted one."""
    model = Model("k * dxxU", "U", "k", double=True)
    N, B = 32, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (m + 1)) for m in range(B)])
    pars = [dict(k=0.5 * (m + 1), periodic=True) for m in range(B)]

    ens = Ensemble(model, u0, pars, x, scheme=schemes.RODASPR, tol=1e-6)
    ens.step(0.2)
    ens.step(0.2)
    path = ens.save_checkpoint(tmp_path / "sweep.ckpt")
    ens.step(0.2)
    ens.step(0.2)

    res = Ensemble.from_checkpoint(path, model, scheme=schemes.RODASPR,
                                   tol=1e-6)
    assert res.t == pytest.approx(0.4)
    assert res.id == ens.id
    res.step(0.2)
    res.step(0.2)
    assert res.t == pytest.approx(ens.t)
    assert np.allclose(np.asarray(res.u), np.asarray(ens.u),
                       rtol=1e-12, atol=1e-13)


@pytest.mark.slow
def test_ensemble_checkpoint_per_member_dt(tmp_path):
    """Per-member internal dt (a (B,) array) survives the checkpoint
    round-trip."""
    model = Model("k * dxxU", "U", "k", double=True)
    N = 32
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.tile(np.cos(2 * np.pi * x / 10), (3, 1))
    pars = [dict(k=k, periodic=True) for k in (0.1, 1.0, 10.0)]
    ens = Ensemble(model, u0, pars, x, scheme=schemes.RODASPR, tol=1e-6,
                   per_member_dt=True)
    ens.step(0.3)
    assert getattr(ens._internal_dt, "ndim", 0) == 1
    path = ens.save_checkpoint(tmp_path / "pm.ckpt")
    res = Ensemble.from_checkpoint(path, model, scheme=schemes.RODASPR,
                                   tol=1e-6, per_member_dt=True)
    assert np.allclose(np.asarray(res._internal_dt),
                       np.asarray(ens._internal_dt))
    ens.step(0.3)
    res.step(0.3)
    assert np.allclose(np.asarray(res.u), np.asarray(ens.u),
                       rtol=1e-12, atol=1e-13)


def test_ensemble_dirichlet_hook_matches_simulation():
    """Hooks on the vmapped member axis get scheme-stepper semantics: the
    Dirichlet hook applies per attempt AND at output time, so each member
    reproduces a standalone Simulation of the same problem (and the final
    state has the boundary values enforced)."""
    from triflow_jax import Model

    model = Model("k * dxxU - c * dxU", "U", ["k", "c"])
    N, B = 128, 3
    x = np.linspace(0, 1, N)
    rng = np.random.RandomState(2)
    u0 = np.stack([np.cos(2 * np.pi * x * 5 + p) for p in rng.rand(B)])
    kvals = [1e-3, 2e-3, 4e-3]
    pars = [dict(k=k, c=3e-3, periodic=False) for k in kvals]

    def dirichlet(t, fields, pars):
        fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
        return fields, pars

    ens = Ensemble(model, u0, pars, x, scheme=schemes.Theta, theta=1.0,
                   hook=dirichlet)
    t, u = ens.run(tmax=10.0, dt=1.0)
    U = np.asarray(u)
    assert U[:, 0, 0] == pytest.approx(1.0)
    assert U[:, 0, -1] == pytest.approx(0.0, abs=1e-12)

    for i, k in enumerate(kvals):
        simul = Simulation(
            model, model.fields_template(x=x, U=u0[i]),
            dict(k=k, c=3e-3, periodic=False), scheme=schemes.Theta,
            theta=1.0, time_stepping=False, hook=dirichlet, dt=1.0,
            tmax=10.0,
        )
        for ts, fields in simul:
            pass
        assert np.allclose(U[i, 0], np.asarray(fields["U"]),
                           rtol=1e-9, atol=1e-11)


@pytest.mark.slow
def test_ensemble_recompute_target_false_per_member():
    """VERDICT r2 item 2: ``recompute_target=False`` (the reference's
    interpolation semantics, schemes.py:213-227) must be honored by the
    per-member Ensemble controller — each member overshoots on its own
    internal grid and interpolates to the output time, matching a single
    scheme-level run with the same flag."""
    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble

    model = Model("k * dxxU", "U", "k")
    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(x * 2 * np.pi / 10)
    ks = [0.05, 0.5, 5.0]
    B = len(ks)
    tol = 1e-6

    ens = Ensemble(model, np.tile(u0, (B, 1)),
                   [dict(k=k, periodic=True) for k in ks], x,
                   scheme=schemes.RODASPR, tol=tol, per_member_dt=True,
                   recompute_target=False)
    t, u = ens.step(0.7)
    assert t == pytest.approx(0.7)

    for b, k in enumerate(ks):
        scheme = schemes.RODASPR(model, time_stepping=True, tol=tol,
                                 recompute_target=False)
        fields = model.fields_template(x=x, U=u0)
        _t_ref, f_ref = scheme(0.0, fields, 0.7, dict(k=k, periodic=True))
        assert np.allclose(np.asarray(ens.u[b, 0]),
                           np.asarray(f_ref["U"]), atol=1e-8), b


def test_ensemble_recompute_target_false_shared_dt():
    """Shared-dt controller with identical members + recompute_target=False
    reduces exactly to the single-run interpolating controller (the max
    member error equals every member's error)."""
    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble

    model = Model("k * dxxU - U * dxU", "U", "k")
    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(x * 2 * np.pi / 10)
    B, tol = 3, 1e-6

    ens = Ensemble(model, np.tile(u0, (B, 1)), dict(k=1.0, periodic=True),
                   x, scheme=schemes.RODASPR, tol=tol,
                   recompute_target=False)
    t, u = ens.step(0.5)
    assert t == pytest.approx(0.5)

    scheme = schemes.RODASPR(model, time_stepping=True, tol=tol,
                             recompute_target=False)
    fields = model.fields_template(x=x, U=u0)
    _t_ref, f_ref = scheme(0.0, fields, 0.5, dict(k=1.0, periodic=True))
    for b in range(B):
        assert np.allclose(np.asarray(ens.u[b, 0]),
                           np.asarray(f_ref["U"]), atol=1e-10), b
    # sanity: interpolation mode actually changes the result vs clamping
    ens_clamp = Ensemble(model, np.tile(u0, (B, 1)),
                         dict(k=1.0, periodic=True), x,
                         scheme=schemes.RODASPR, tol=tol)
    ens_clamp.step(0.5)
    assert not np.allclose(np.asarray(ens.u), np.asarray(ens_clamp.u),
                           atol=1e-12)


# ---------------------------------------------------------------------------
# df64 ensembles (VERDICT r3 missing #1: precision x parallelism).  Configs
# are compile-economical: 2-3 stage schemes, small grids — the df64 traces
# are large and the suite is compile-bound on CPU.
# ---------------------------------------------------------------------------

def test_ensemble_df64_never_selects_f32_merged():
    """Construction-time guard (r3 regression): a df64 Ensemble must carry
    double-float member state — an f32 path silently produced f32 physics
    in r3.  Cheap (no trajectory); the full parity trajectory lives in
    test_ensemble_df64_matches_single_runs (nightly)."""
    N, B = 64, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (i + 1))
                   for i in range(B)])[:, None, :]
    pars = [dict(k=k, periodic=True) for k in (0.3, 0.5, 0.8)]
    model = Model("k * dxxU - U * dxU", "U", "k", double="df64")
    ens = Ensemble(model, u0, pars, x, scheme=schemes.ROS2)
    from triflow_jax.ops.df64 import DF
    assert isinstance(ens.u, DF)


@pytest.mark.slow
def test_ensemble_df64_matches_single_runs():
    """An Ensemble built from a df64 model must run REAL double-float
    physics: members match independent df64 scheme runs to <= 1e-12 and
    the output genuinely differs from an f32 ensemble (r3's silent
    downgrade)."""
    from triflow_jax.ops.df64 import DF

    N, B = 64, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (i + 1))
                   for i in range(B)])[:, None, :]
    ks = [0.3, 0.5, 0.8]
    pars = [dict(k=k, periodic=True) for k in ks]
    model = Model("k * dxxU - U * dxU", "U", "k", double="df64")

    ens = Ensemble(model, u0, pars, x, scheme=schemes.ROS2)
    t, u = ens.run(tmax=0.5, dt=0.125)
    assert isinstance(u, DF)

    scheme = schemes.ROS2(model)      # one shared instance: one compile
    for i in range(B):
        t_, f_ = 0.0, model.fields_template(x=x, U=u0[i, 0])
        for _ in range(4):
            t_, f_ = scheme(t_, f_, 0.125, dict(k=ks[i], periodic=True))
        assert np.abs(u.to_float64()[i, 0]
                      - np.asarray(f_["U"])).max() < 1e-12, i

    m32 = Model("k * dxxU - U * dxU", "U", "k", double=False)
    e32 = Ensemble(m32, u0, pars, x, scheme=schemes.ROS2)
    e32.run(tmax=0.5, dt=0.125)
    d = np.abs(np.asarray(e32.u, np.float64) - u.to_float64()).max()
    assert d > 1e-9      # bit-identical output was the r3 failure mode


@pytest.mark.slow
def test_ensemble_df64_adaptive_per_member():
    """Adaptive df64 ensembles: shared-dt and per-member controllers both
    run on DF state (tree-aware masking, compensated member clocks) and
    land in the single-run df64 accuracy class.  Mixed stage solves keep
    the trace small (the recommended production config)."""
    N, B = 64, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (i + 1))
                   for i in range(B)])[:, None, :]
    pars = [dict(k=k, periodic=True) for k in (0.3, 0.5, 0.8)]
    model = Model("k * dxxU - U * dxU", "U", "k", double="df64")

    shared = Ensemble(model, u0, pars, x, scheme=schemes.ROS3PRw,
                      tol=1e-9, df64_mixed_solve=1)
    t1, u1 = shared.run(tmax=0.25, dt=0.125)
    per = Ensemble(model, u0, pars, x, scheme=schemes.ROS3PRw,
                   tol=1e-9, df64_mixed_solve=1, per_member_dt=True)
    t2, u2 = per.run(tmax=0.25, dt=0.125)
    assert t1 == pytest.approx(0.25) and t2 == pytest.approx(0.25)
    assert per.member_iters is not None and per.member_iters.min() >= 1
    # both controllers integrate to the tolerance: states agree to ~tol
    assert np.abs(u1.to_float64() - u2.to_float64()).max() < 1e-7


def test_ensemble_df64_recompute_target_false():
    """df64 + ``recompute_target=False``: the per-member output
    interpolation must run in DF arithmetic (advisor r4 medium: a
    leaf-wise f32 lerp loses ~ulp(hi)/2 ~ 6e-8 into nowhere, silently
    degrading the carried df64 trajectory).  Each member matches a single
    scheme-level df64 run with the same flag to the df64 class."""
    from triflow_jax.ops.df64 import DF

    model = Model("k * dxxU", "U", "k", double="df64")
    N = 32
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(x * 2 * np.pi / 10)
    ks = [0.4, 1.3]
    B, tol = len(ks), 1e-7

    ens = Ensemble(model, np.tile(u0, (B, 1)),
                   [dict(k=k, periodic=True) for k in ks], x,
                   scheme=schemes.ROS3PRw, tol=tol, per_member_dt=True,
                   recompute_target=False, df64_mixed_solve=1)
    t, u = ens.step(0.7)
    assert t == pytest.approx(0.7)
    assert isinstance(u, DF)

    scheme = schemes.ROS3PRw(model, time_stepping=True, tol=tol,
                             recompute_target=False, df64_mixed_solve=1)
    for b, k in enumerate(ks):
        scheme._internal_dt = None       # fresh dt seed per member
        fields = model.fields_template(x=x, U=u0)
        _t_ref, f_ref = scheme(0.0, fields, 0.7, dict(k=k, periodic=True))
        d = np.abs(u.to_float64()[b, 0] - np.asarray(f_ref["U"])).max()
        assert d < 1e-11, (b, d)


def test_ensemble_df64_checkpoint_roundtrip(tmp_path):
    """df64 ensemble checkpoints store the exact f64 value (hi + lo) and
    the rebuilt DF pair is bit-identical (utils/checkpoint.py)."""
    N, B = 48, 2
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + i) for i in range(B)])
    pars = [dict(k=0.5, periodic=True)] * B
    model = Model("k * dxxU", "U", "k", double="df64")
    ens = Ensemble(model, u0, pars, x, scheme=schemes.Theta, theta=1.0)
    ens.run(tmax=0.25, dt=0.125)
    path = tmp_path / "ens_df64.h5"
    ens.save_checkpoint(path)
    ens2 = Ensemble.from_checkpoint(path, model, scheme=schemes.Theta,
                                    theta=1.0)
    assert ens2.t == pytest.approx(ens.t)
    assert np.array_equal(np.asarray(ens2.u.hi), np.asarray(ens.u.hi))
    assert np.array_equal(np.asarray(ens2.u.lo), np.asarray(ens.u.lo))
    # resuming steps fine
    ens2.run(tmax=0.5, dt=0.125)
