"""Wave equation as a first-order system with Dirichlet walls
(reference: examples/notebooks/wave_equation.ipynb)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

model = Model(["c**2 * dxxu", "v"], ["v", "u"], "c")
x = np.linspace(0, 10, 500, endpoint=False)
u = np.exp(-((x - 5) ** 2) * 4)
v = np.zeros_like(x)


def dirichlet(t, fields, pars):
    fields["u"] = fields["u"].at[0].set(0.0).at[-1].set(0.0)
    fields["v"] = fields["v"].at[0].set(0.0).at[-1].set(0.0)
    return fields, pars


simulation = Simulation(model, model.fields_template(x=x, v=v, u=u),
                        dict(periodic=False, c=1.0),
                        hook=dirichlet, dt=0.1, tmax=5, tol=1e-8)
for t, fields in simulation:
    pass
print(f"t = {t:g}; reflected pulse max = "
      f"{np.abs(np.asarray(fields['u'])).max():.3f}")

# hyperbolic systems are non-stiff: the explicit Dormand-Prince 5(4) pair
# (stages = stencil F evals only, no factorization) is the cheap option
from triflow_jax import schemes  # noqa: E402

explicit = Simulation(model, model.fields_template(x=x, v=v, u=u),
                      dict(periodic=False, c=1.0), hook=dirichlet,
                      scheme=schemes.DOPRI5, dt=0.1, tmax=5, tol=1e-8)
for t, fields in explicit:
    pass
print(f"explicit DOPRI5: t = {t:g}; reflected pulse max = "
      f"{np.abs(np.asarray(fields['u'])).max():.3f}")
