"""Combined dp x sp: a parameter sweep whose members AND grids both shard
over a 2-D device mesh — members over the "ensemble" axis (zero
collectives), every member's grid over the "space" axis (halo rings +
distributed SPIKE solve).  With per_member_dt each member runs its own
error-controlled internal step sequence (run under
XLA_FLAGS=--xla_force_host_platform_device_count=8 for a virtual mesh)."""

import numpy as np
from _common import setup

setup()

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from triflow_jax import Model, schemes  # noqa: E402
from triflow_jax.parallel import Ensemble  # noqa: E402

ndev = len(jax.devices())
ne = 2 if ndev % 2 == 0 else 1
ns = ndev // ne
mesh = Mesh(np.array(jax.devices()[: ne * ns]).reshape(ne, ns),
            ("ensemble", "space"))

model = Model("k * dxxU - U * dxU", "U", "k")
N, B = 512 * ns, 2 * ne
x = np.linspace(0, 50, N, endpoint=False)
rng = np.random.RandomState(0)
u0 = np.stack([np.cos(2 * np.pi * x / 50 + p) for p in rng.rand(B)])
ks = np.logspace(-2, 0.5, B)                      # heterogeneous stiffness
pars = [dict(k=float(k), periodic=True) for k in ks]

ens = Ensemble(model, u0, pars, x, scheme=schemes.RODASPR, tol=1e-5,
               per_member_dt=True, mesh=mesh, space_axis="space")
t, u = ens.run(tmax=2.0, dt=0.5)

print(f"t = {t:g}; B = {B} members x N = {N} nodes over "
      f"{dict(mesh.shape)}; state on {len(ens.u.sharding.device_set)} "
      f"devices; per-member attempts (last step) = "
      f"{list(map(int, ens.member_iters))}")
