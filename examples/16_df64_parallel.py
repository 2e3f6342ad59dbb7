"""Precision AND parallelism together: df64 ensembles and df64 sharding.

Round 4 made ``double="df64"`` compose with the parallel layer — the
reference's unconditional f64 (upstream triflow/core/model.py:148)
holds no matter how a run is driven, and so does df64 here:

* an ``Ensemble`` built from a df64 model runs double-float members
  (vmapped over the member axis);
* ``Simulation(..., mesh=...)`` shards DF state over the device mesh and
  runs MIXED-precision distributed stage solves: the f32 SPIKE
  factorization of the rounded system preconditions df64-residual
  correction passes against the df64 operator (one extra halo ring per
  pass).

This example runs a small df64 Burgers parameter sweep and a df64 sharded
KS run on a virtual 8-device CPU mesh, and prints how far each sits from
its single-run / single-device df64 twin (both land at double-float
round-off, orders below anything f32 could produce).
"""

import os

# the virtual device count must be set before the first jax backend touch
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
from _common import setup

setup()

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from triflow_jax import Model, Simulation, schemes  # noqa: E402
from triflow_jax.parallel import Ensemble  # noqa: E402

# --- df64 parameter sweep -------------------------------------------------
N, B = 96, 3
x = np.linspace(0, 10, N, endpoint=False)
u0 = np.stack([np.cos(2 * np.pi * x / 10 * (i + 1)) for i in range(B)])
ks = [0.3, 0.5, 0.8]
model = Model("k * dxxU - U * dxU", "U", "k", double="df64")

ens = Ensemble(model, u0, [dict(k=k, periodic=True) for k in ks], x,
               scheme=schemes.ROS2)
t, u = ens.run(tmax=0.5, dt=0.125)
print(f"df64 ensemble: B={B} members advanced to t={t}")

scheme = schemes.ROS2(model)
worst = 0.0
for i, k in enumerate(ks):
    ti, fi = 0.0, model.fields_template(x=x, U=u0[i])
    for _ in range(4):
        ti, fi = scheme(ti, fi, 0.125, dict(k=k, periodic=True))
    worst = max(worst,
                np.abs(u.to_float64()[i, 0] - np.asarray(fi["U"])).max())
print(f"  max |ensemble - independent df64 runs| = {worst:.3g}"
      "  (f32 would sit at ~1e-6)")

# --- df64 spatial sharding ------------------------------------------------
mesh = Mesh(np.array(jax.devices()[:8]), ("space",))
ksm = Model("-dxxU - dxxxxU - U * dxU", "U", double="df64")
Ns = 256
xs = np.arange(Ns) * 0.5
u0s = np.cos(0.1 * xs) + 0.05 * np.random.RandomState(0).randn(Ns)


def run(mesh_arg):
    kw = dict(mesh=mesh_arg) if mesh_arg is not None else {}
    sim = Simulation(ksm, ksm.fields_template(x=xs, U=u0s),
                     dict(periodic=True), dt=0.125, tmax=0.5,
                     scheme=schemes.ROS2, time_stepping=False, **kw)
    for t, fields in sim:
        pass
    return np.asarray(fields["U"])


ref = run(None)
sharded = run(mesh)
print(f"df64 sharded KS over {mesh.shape['space']} devices: "
      f"max |sharded - single-device df64| = "
      f"{np.abs(sharded - ref).max():.3g}")
