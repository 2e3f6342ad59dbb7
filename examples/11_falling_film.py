"""Coupled falling-film h/q model (Shkadov averaged equations): 2-variable
system with block-banded Jacobian and upwind advection (BASELINE config 4)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model(
    ["-dxq",
     "9/7 * q**2 / h**2 * dxh - upwind(17/7 * q / h, q, 2)"
     " + (h - q / h**2) / delta"],
    ["h", "q"], ["delta"],
)

x = np.linspace(0, 100, 1000, endpoint=False)
h = 1 + 0.1 * np.cos(2 * np.pi * x / 100 * 3)
q = h ** 3 / 3  # Nusselt flat-film flux

simulation = Simulation(model, model.fields_template(x=x, h=h, q=q),
                        dict(periodic=True, delta=0.1),
                        dt=0.5, tmax=20, tol=1e-4)
for t, fields in simulation:
    pass
hf = np.asarray(fields["h"])
print(f"t = {t:g}; film height in [{hf.min():.3f}, {hf.max():.3f}], "
      f"mass drift = {np.abs(hf.mean() - h.mean()):.2e}")
