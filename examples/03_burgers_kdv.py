"""Burgers-KdV: advection + diffusion + dispersion
(reference: examples/notebooks/burger_kdv_equation.ipynb)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model("-U * dxU + a * dxxU + b * dxxxU", "U", ["a", "b"])
x = np.linspace(-10, 10, 500, endpoint=False)
U = np.exp(-x ** 2)

simulation = Simulation(model, model.fields_template(x=x, U=U),
                        dict(periodic=True, a=0.05, b=0.1),
                        dt=0.05, tmax=10, tol=1e-4)
for t, fields in simulation:
    pass
print(f"t = {t:g}; dispersive tail amplitude = "
      f"{np.abs(np.asarray(fields['U'])[:100]).max():.4f}")
