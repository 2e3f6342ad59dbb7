"""Persist and resume a whole parameter sweep: one container for the batch
(frames carry a ``member`` axis) and a one-call checkpoint/resume.

The reference's sweep persistence is one container per pickled-model process
(upstream source_doc/source/user_guide.rst:125-138); here the sweep is
a single device computation, so it lands in a single container."""

import tempfile
from pathlib import Path

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, retrieve_container, schemes  # noqa: E402
from triflow_jax.parallel import Ensemble  # noqa: E402

model = Model("k * dxxU - U * dxU", "U", "k")
N, B = 256, 16
x = np.linspace(0, 10, N, endpoint=False)
ks = np.linspace(0.05, 0.5, B)
u0 = np.tile(np.cos(2 * np.pi * x / 10), (B, 1))

out = Path(tempfile.mkdtemp()) / "sweep"
ens = Ensemble(model, u0, [dict(k=float(k), periodic=True) for k in ks], x,
               scheme=schemes.RODASPR, tol=1e-4)
ens.attach_container(str(out))          # member parameter values -> metadata
ens.run(tmax=1.0, dt=0.25)

ckpt = ens.save_checkpoint(out / "sweep.ckpt")
resumed = Ensemble.from_checkpoint(ckpt, model,
                                   scheme=schemes.RODASPR, tol=1e-4)
resumed.run(tmax=2.0, dt=0.25)

data = retrieve_container(str(out / ens.id)).data
print(f"persisted {data['U'].shape} (T, B, N) frames; "
      f"resumed run t = {resumed.t:g}; "
      f"|u|max = {float(np.abs(np.asarray(resumed.u)).max()):.3f}")
