"""Hand-written (duck-typed) 2D shallow-water model stepped with scipy_ode —
no symbolic layer: any object exposing .F(fields, pars) and .fields_template
works (reference: examples/notebooks/manual_2D_model.ipynb; scheme proxy
schemes.py:430-499)."""

import numpy as np
from _common import setup

setup()

from triflow_jax import Simulation, schemes, factory  # noqa: E402

Nx, Ny = 32, 24
x = np.linspace(0, 10, Nx, endpoint=False)
y = np.linspace(0, 8, Ny, endpoint=False)
dx = x[1] - x[0]
dy = y[1] - y[0]


def d_x(U):
    return (np.roll(U, -1, axis=0) - np.roll(U, 1, axis=0)) / (2 * dx)


def d_y(U):
    return (np.roll(U, -1, axis=1) - np.roll(U, 1, axis=1)) / (2 * dy)


def lap(U):
    return (
        (np.roll(U, 1, 0) - 2 * U + np.roll(U, -1, 0)) / dx ** 2
        + (np.roll(U, 1, 1) - 2 * U + np.roll(U, -1, 1)) / dy ** 2
    )


class NonConservativeShallowWater:
    """Linearized-friction shallow water over flat bathymetry H."""

    fields_template = factory(
        ("x", "y"),
        [("h", ("x", "y")), ("u", ("x", "y")), ("v", ("x", "y"))],
        [("H", ("x", "y"))],
    )

    @staticmethod
    def F(fields, pars):
        h = np.asarray(fields["h"])
        u = np.asarray(fields["u"])
        v = np.asarray(fields["v"])
        H = np.asarray(fields["H"])
        g, nu, f = 9.81, pars["nu"], pars["f"]
        eta = h + H
        dth = -(d_x(u * eta) + d_y(v * eta))
        dtu = -g * d_x(h) + f * v + nu * lap(u) - u * d_x(u) - v * d_y(u)
        dtv = -g * d_y(h) - f * u + nu * lap(v) - u * d_x(v) - v * d_y(v)
        # flat layout must match Fields.uflat: per x-row, the h / u / v
        # row blocks concatenated (fields.py fill/uflat convention)
        return np.concatenate([dth, dtu, dtv], axis=1).reshape(-1)


model = NonConservativeShallowWater()
h0 = 0.1 * np.exp(-(((x[:, None] - 5) ** 2) + (y[None, :] - 4) ** 2))
fields = model.fields_template(
    x=x, y=y, h=h0, u=np.zeros((Nx, Ny)), v=np.zeros((Nx, Ny)),
    H=np.ones((Nx, Ny)),
)

simul = Simulation(model, fields, {"f": 0.0, "nu": 1e-6}, dt=0.01, tmax=0.4,
                   scheme=schemes.scipy_ode, time_stepping=False)
for t, fields in simul:
    pass
h = np.asarray(fields["h"])
print(f"t = {t:g}; gravity-wave ring: h range [{h.min():.4f}, {h.max():.4f}],"
      f" mass drift = {np.abs(h - h0).mean():.2e}")
