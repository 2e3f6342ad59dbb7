"""Checkpoint/resume: a run interrupted at t1 and resumed must match an
uninterrupted run bit-for-bit (same scheme internal dt carried over)."""

import numpy as np
import pytest

from triflow_jax import Model, Simulation
from triflow_jax.utils.profiling import step_breakdown


@pytest.fixture(scope="module")
def burgers():
    return Model("k * dxxU - U * dxU", "U", "k")


def _initial(model, N=128):
    x = np.linspace(0, 10, N, endpoint=False)
    return model.fields_template(x=x, U=np.cos(2 * np.pi * x / 10))


def test_checkpoint_resume_matches_uninterrupted(burgers, tmp_path):
    pars = dict(periodic=True, k=0.3)

    # uninterrupted run to t=2
    ref = Simulation(burgers, _initial(burgers), dict(pars),
                     dt=0.5, tmax=2.0, tol=1e-8)
    ref.run(progress=False)

    # interrupted at t=1, checkpointed, resumed
    first = Simulation(burgers, _initial(burgers), dict(pars),
                       dt=0.5, tmax=2.0, tol=1e-8)
    for t, fields in first:
        if t >= 1.0:
            break
    ckpt = tmp_path / "run.ckpt.h5"
    first.save_checkpoint(ckpt)

    resumed = Simulation.from_checkpoint(ckpt, burgers, tol=1e-8)
    assert resumed.t == pytest.approx(1.0)
    assert resumed.i == first.i
    assert resumed._scheme._internal_dt == pytest.approx(
        first._scheme._internal_dt
    )
    resumed.run(progress=False)

    assert resumed.t == pytest.approx(2.0)
    assert np.allclose(
        np.asarray(resumed.fields["U"]), np.asarray(ref.fields["U"]),
        rtol=1e-12, atol=1e-12,
    )


def test_checkpoint_preserves_parameters(burgers, tmp_path):
    pars = dict(periodic=True, k=0.123)
    simul = Simulation(burgers, _initial(burgers), pars, dt=0.5, tmax=5,
                       tol=1e-4)
    next(simul)
    ckpt = tmp_path / "p.h5"
    simul.save_checkpoint(ckpt)
    resumed = Simulation.from_checkpoint(ckpt, burgers, tol=1e-4)
    assert resumed.parameters["k"] == pytest.approx(0.123)
    assert bool(resumed.parameters["periodic"]) is True
    assert resumed.tmax == 5


def test_failure_flushes_container(burgers, tmp_path):
    """On RuntimeError the buffered snapshots must land on disk."""
    pars = dict(periodic=True, k=0.3)
    simul = Simulation(burgers, _initial(burgers), pars,
                       dt=0.5, tmax=10, tol=1e-6, max_iter=3)
    simul.attach_container(str(tmp_path), nbuffer=1000)  # never auto-flush
    with pytest.raises(RuntimeError):
        simul.run(progress=False)
    assert simul.status == "failed"
    files = list((tmp_path / simul.id).glob("data_*.h5"))
    assert files, "no data chunk written on failure"


def test_step_breakdown(burgers):
    simul = Simulation(burgers, _initial(burgers), dict(periodic=True, k=0.3),
                       dt=0.5, tol=1e-4)
    out = step_breakdown(simul, n=2)
    assert out["total_s"] > 0
    assert out["per_step_s"] > 0
