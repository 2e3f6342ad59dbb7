"""Real-time displays: live field plots + a scalar probe with on-disk
frame capture (reference notebook: examples/notebooks/displays.ipynb;
display implementation upstream triflow/plugins/displays.py:89-142).

Demonstrates the three display modes:

* ``display_fields`` — one curve per dependent variable, redrawn on every
  emitted step; ``on_disk=...`` writes one image per frame.
* ``display_probe`` — a user scalar (here the L2 norm and the solver's
  wall-time per step) charted over the run with a ring buffer.
* inside a notebook the same calls are SELF-UPDATING: the figure is
  published through an IPython display handle and each frame replaces it
  in place (``live=None`` auto-detects the kernel; the reference gets
  this from holoviews DynamicMap/Pipe).

Run as a script this writes frames under ./_frames and prints the count.
"""

import shutil
import tempfile
from pathlib import Path

import numpy as np
from _common import setup

setup()

from triflow_jax import (  # noqa: E402
    Model,
    Simulation,
    display_fields,
    display_probe,
    schemes,
)

model = Model("k * dxxU - U * dxU", "U", "k")

N = 256
x = np.linspace(0, 10, N, endpoint=False)
U = np.cos(2 * np.pi * x / 10) + 0.2 * np.cos(4 * np.pi * x / 10)

simulation = Simulation(
    model,
    model.fields_template(x=x, U=U),
    dict(periodic=True, k=0.05),
    dt=0.25,
    tmax=5.0,
    scheme=schemes.RODASPR,
    tol=1e-4,
)

frames = Path(tempfile.mkdtemp(prefix="triflow_frames_"))

# one image per output step under frames/; in a notebook the same call
# also renders a self-updating figure in the cell
fields_view = display_fields(simulation, on_disk=str(frames),
                             on_disk_name="burgers")

# scalar probe: the L2 norm of U over time (ring buffer of 50 points)
probe = display_probe(
    simulation, lambda s: float(np.sqrt(np.mean(np.square(
        np.asarray(s.fields["U"]))))),
    ylabel="||U||_2", buffer=50, on_disk=str(frames),
    on_disk_name="norm_probe",
)

for t, fields in simulation:
    pass

field_frames = sorted(frames.glob("burgers_*.png"))
probe_frames = sorted(frames.glob("norm_probe_*.png"))
steps = simulation.i
print(f"t = {t:g} after {steps} output steps; "
      f"{len(field_frames)} field frames + {len(probe_frames)} probe "
      f"frames written to {frames}")
assert len(field_frames) == steps + 1  # +1: the initial frame
assert len(probe_frames) == steps + 1
shutil.rmtree(frames)
