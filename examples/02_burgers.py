"""Periodic viscous Burgers with nonlinear Jacobian
(reference: examples/notebooks/burger_equation.ipynb)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model("k * dxxU - U * dxU", "U", "k")
x = np.linspace(0, 10, 500, endpoint=False)
U = np.cos(2 * np.pi * x / 10)

simulation = Simulation(model, model.fields_template(x=x, U=U),
                        dict(periodic=True, k=0.05),
                        dt=0.5, tmax=10, tol=1e-6)
for t, fields in simulation:
    pass
U = np.asarray(fields["U"])
print(f"t = {t:g}; shock steepened: max|dU/dx| = "
      f"{np.abs(np.gradient(U, x)).max():.2f} (initial {2*np.pi/10:.2f})")
