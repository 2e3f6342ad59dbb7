"""Thin-film droplet spreading: 4th-order nonlinear lubrication equation
with a disjoining-pressure precursor film
(reference: examples/notebooks/dropplet_spread.ipynb)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model(
    "dx((h**3 + h**2) * dx(-sigma * dxxh + alpha * (1 / h**3 - e / h**4)))",
    "h", ["sigma", "alpha", "e"],
)
x = np.linspace(0, 10, 300, endpoint=False)
h = np.maximum(0.05, 1 - ((x - 5) / 2) ** 2)

simulation = Simulation(model, model.fields_template(x=x, h=h),
                        dict(periodic=False, alpha=0.05, sigma=10, e=0.1),
                        dt=0.01, tmax=0.5, tol=1e-1)
for t, fields in simulation:
    pass
hf = np.asarray(fields["h"])
print(f"t = {t:g}; droplet height = {hf.max():.3f}, precursor film = "
      f"{hf.min():.4f}, volume drift = {np.trapezoid(hf - h, x):.2e}")
