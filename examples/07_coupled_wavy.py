"""Coupled convection pair (reference: examples/notebooks/so_wavy.ipynb)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model(["k * dxxU - c * U * dxV",
               "k * dxxV - c * V * dxU"],
              ["U", "V"], ["k", "c"])
x = np.linspace(0, 10, 500, endpoint=False)
U = 0.5 * np.cos(2 * np.pi * x / 10)
V = 0.5 * np.sin(2 * np.pi * x / 10)

# the reference notebook's (k=0.05, c=1) pair blows up in finite time
# (t ~ 1.3); this choice stays wavy but bounded
simulation = Simulation(model, model.fields_template(x=x, U=U, V=V),
                        dict(periodic=True, k=0.4, c=1.0),
                        dt=0.1, tmax=4, tol=1e-2)
for t, fields in simulation:
    pass
print(f"t = {t:g}; |U|max = {np.abs(np.asarray(fields['U'])).max():.3f}, "
      f"|V|max = {np.abs(np.asarray(fields['V'])).max():.3f}")
