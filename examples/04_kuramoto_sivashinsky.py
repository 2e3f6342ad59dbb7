"""Kuramoto-Sivashinsky: stiff 4th-order chaos, adaptive RODASPR
(reference: examples/notebooks/kuramoto.ipynb, BASELINE config 3).

The reference writes it as "-dxxzeta - dxxxxzeta + (dxzeta)**2"; the
derivative (u = dx zeta) form "-dxxU - dxxxxU - U*dxU" is equivalent."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model("-dxxzeta - dxxxxzeta + (dxzeta)**2", "zeta")
L = 32 * np.pi
x = np.linspace(0, L, 512, endpoint=False)
rng = np.random.RandomState(0)
zeta = np.cos(2 * np.pi * x / L * 4) + 0.01 * rng.randn(x.size)

simulation = Simulation(model, model.fields_template(x=x, zeta=zeta),
                        dict(periodic=True), dt=1.0, tmax=50, tol=1e-2)
for t, fields in simulation:
    pass
z = np.asarray(fields["zeta"])
print(f"t = {t:g}; KS cellular state: std = {z.std():.3f}, finite = "
      f"{np.isfinite(z).all()}")
