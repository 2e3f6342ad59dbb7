"""README workload: advection-diffusion with a Dirichlet hook
(reference: upstream README.md:110-143)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation, schemes  # noqa: E402

model = Model("k * dxxU - c * dxU", "U", ["k", "c"])

x, dx = np.linspace(0, 1, 200, retstep=True)
U = np.cos(2 * np.pi * x * 5)


def dirichlet_condition(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    return fields, pars


simulation = Simulation(
    model,
    model.fields_template(x=x, U=U),
    dict(periodic=False, k=1e-3, c=3e-3),
    hook=dirichlet_condition,
    dt=5.0,
    tmax=2500,
    scheme=schemes.Theta,
    theta=1.0,
)

for t, fields in simulation:
    pass

U_final = np.asarray(fields["U"])
print(f"t = {t:g}; U[0] = {U_final[0]:.3f}, U[-1] = {U_final[-1]:.3f}, "
      f"steady-state range [{U_final.min():.3f}, {U_final.max():.3f}]")
