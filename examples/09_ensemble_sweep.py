"""Data-parallel parameter sweep: many Burgers instances vmapped together
(BASELINE config 5 pattern; across chips the member axis shards over a mesh
'ensemble' axis)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, schemes  # noqa: E402
from triflow_jax.parallel import Ensemble  # noqa: E402

model = Model("k * dxxU - U * dxU", "U", "k")
N, B = 256, 64
x = np.linspace(0, 10, N, endpoint=False)
ks = np.linspace(0.01, 0.5, B)
u0 = np.tile(np.cos(2 * np.pi * x / 10), (B, 1))

ens = Ensemble(model, u0, [dict(k=float(k), periodic=True) for k in ks], x,
               scheme=schemes.RODASPR, tol=1e-4)
# steps_per_call scans several output steps inside one device call,
# amortizing the host sync per call
t, u = ens.run(tmax=2.0, dt=0.5, steps_per_call=4)
grad_max = np.abs(np.gradient(np.asarray(u[:, 0]), x, axis=-1)).max(axis=-1)
print(f"t = {t:g}; {B} members; steepest front (k={ks[grad_max.argmax()]:.2f})"
      f" |dU/dx|max = {grad_max.max():.2f}; smoothest (k={ks[grad_max.argmin()]:.2f})"
      f" = {grad_max.min():.2f}")
