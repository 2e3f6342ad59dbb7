"""Double-float precision from float32 arithmetic: ``double="df64"``.

The reference computes in float64 natively (SuperLU solves,
upstream triflow/core/schemes.py:148-163; ``double=True`` default at
model.py:148).  ``double="df64"`` instead carries every value as a
double-float (hi, lo) pair of f32s (~49-bit significand, ops/df64.py) and
matches CPU float64 trajectories to ~1e-13.  ``df64_mixed_solve=1`` runs
the stage solves as f32-preconditioned df64-residual refinement at the
same accuracy.

This example integrates the advection-diffusion cosine mode, for which the
exact solution of the DISCRETE operator is known in closed form, and prints
the f32 / df64 error against it.
"""

import numpy as np
from _common import setup

setup()

from triflow_jax import Model, Simulation  # noqa: E402

N = 256
x, dx = np.linspace(0, 10, N, endpoint=False, retstep=True)
om = 2 * np.pi / 10
U0 = np.cos(om * x)
k, c, T = 0.05, 0.3, 2.0

# exact solution of the discretized operator (cosine eigenmode)
lam = k * (2 * np.cos(om * dx) - 2) / dx ** 2
mu = c * np.sin(om * dx) / dx
exact = np.exp(lam * T) * np.cos(om * x - mu * T)


def run(double, tol, **scheme_kwargs):
    model = Model("k * dxxU - c * dxU", "U", ["k", "c"], double=double)
    sim = Simulation(model, model.fields_template(x=x, U=U0),
                     dict(periodic=True, k=k, c=c), dt=0.5, tmax=T,
                     tol=tol, **scheme_kwargs)
    for t, fields in sim:
        pass
    return np.max(np.abs(np.asarray(fields["U"], dtype=np.float64) - exact))


# f32's embedded error floors at its representation (~1e-7) — a tighter
# tolerance would just trip the dt-floor guard; df64 can honor 1e-12
err_f32 = run(False, tol=1e-6)
err_df64 = run("df64", tol=1e-12, df64_mixed_solve=1)
print(f"f32  error vs exact discrete solution: {err_f32:.3e}")
print(f"df64 error vs exact discrete solution: {err_df64:.3e}  "
      f"(<= 1e-8 reference-grade target)")
assert err_df64 < 1e-8
