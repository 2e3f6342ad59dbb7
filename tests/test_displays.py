"""Headless display smoke tests, mirroring
upstream tests/test_displays.py: Agg rendering of fields/probe
displays, and the on-disk frame count must equal the number of steps."""

import numpy as np
import pytest

from triflow_jax import Model, Simulation, display_fields, display_probe


@pytest.fixture(scope="module")
def heat_model():
    return Model("k * dxxT", "T", "k")


def make_simul(heat_model, tmax=5):
    x = np.linspace(0, 10, 50, endpoint=False)
    T = np.cos(x * 2 * np.pi / 10)
    fields = heat_model.fields_template(x=x, T=T)
    return Simulation(heat_model, fields, dict(periodic=True, k=1),
                      dt=1, tmax=tmax, tol=1e-1)


def test_display_fields(heat_model):
    simul = make_simul(heat_model)
    display_fields(simul)
    simul.run(progress=False)


def test_display_probe(heat_model):
    simul = make_simul(heat_model)
    display_probe(simul, function=lambda s: s.timer.total)
    simul.run(progress=False)


@pytest.mark.parametrize("fmt", ["png", "svg", "pdf"])
def test_display_on_disk_frame_count(heat_model, tmp_path, fmt):
    simul = make_simul(heat_model, tmax=5)
    display_fields(simul, on_disk=str(tmp_path), fmt=fmt)
    simul.run(progress=False)
    frames = list(tmp_path.glob(f"*.{fmt}"))
    # initial frame + one per emitted step
    assert len(frames) == simul.i + 1


def test_display_probe_on_disk(heat_model, tmp_path):
    simul = make_simul(heat_model, tmax=3)
    display_probe(simul, function=lambda s: float(np.abs(np.asarray(s.fields["T"])).max()),
                  on_disk=str(tmp_path))
    simul.run(progress=False)
    assert len(list(tmp_path.glob("*.png"))) == simul.i + 1


def test_display_throttle_every(heat_model, tmp_path):
    """every=n draws every n-th emitted frame (plus the initial one)."""
    simul = make_simul(heat_model, tmax=8)
    display_fields(simul, on_disk=str(tmp_path / "thr"), every=2)
    simul.run(progress=False)
    # skeleton frame + every other of the 9 emissions (start emit + 8 steps)
    frames = list((tmp_path / "thr").glob("*.png"))
    assert 2 < len(frames) < 9


def test_display_async_drains_final_frame(heat_model):
    """asynchronous=True never blocks the loop; close() drains so the last
    drawn frame reflects the final state."""
    from triflow_jax.plugins.displays import Display

    simul = make_simul(heat_model, tmax=5)
    seen = []

    def probe(data, fig):
        seen.append(float(data.t))
        ax = fig.add_subplot(111)
        ax.plot(np.asarray(data.fields["T"]))

    d = Display(simul, probe, asynchronous=True)
    d.connect(simul.stream)
    simul.run(progress=False)
    d.close()
    assert seen  # worker drew at least the initial + some frames
    assert seen[-1] == 5.0  # the drained final frame is the last state


def test_live_handle_updates_in_place(heat_model, monkeypatch):
    """The notebook live view re-publishes the figure through its display
    handle on every frame (the reference's DynamicMap/Pipe semantics,
    displays.py:43-73)."""
    from triflow_jax.plugins.displays import Display

    updates = []

    class FakeHandle:
        def update(self, fig):
            updates.append(fig)

    monkeypatch.setattr(Display, "_make_live_handle",
                        lambda self, live: FakeHandle())
    sim = make_simul(heat_model, tmax=3)
    Display.display_fields(sim)
    for _t, _fields in sim:
        pass
    # skeleton draw + the start-of-run emission + one per output step
    assert len(updates) == sim.i + 2


def test_live_disabled_outside_kernel(heat_model):
    sim = make_simul(heat_model, tmax=2)
    d = display_fields(sim, live=False)
    assert d._handle is None
