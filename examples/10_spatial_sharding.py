"""Domain decomposition: KS grid sharded over all available devices with
halo exchange + distributed SPIKE solve (run under
XLA_FLAGS=--xla_force_host_platform_device_count=8 for a virtual mesh)."""

import numpy as np
from _common import setup

setup()

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from triflow_jax import Model, schemes  # noqa: E402
from triflow_jax.parallel.spatial import SpatialModel  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ndev = len(jax.devices())
mesh = Mesh(np.array(jax.devices()), ("space",))
model = Model("-dxxU - dxxxxU - U * dxU", "U")

N = 1024 * ndev
x = np.arange(N) * 0.5
rng = np.random.RandomState(0)
u0 = (np.cos(0.05 * x) + 0.01 * rng.randn(N))[None]

sm = SpatialModel(model, mesh, periodic=True)
step = sm.row_stepper(schemes.RODASPR)
dtype = model.backend.dtype
u = sm.shard(u0)
xs = sm.shard(x)
hs = sm.shard(jnp.zeros((0, N), dtype))
ps = sm.shard(jnp.zeros((0, N), dtype))

t = 0.0
for _ in range(20):
    t, u = step(t, u, hs, ps, xs, 0.1)
print(f"t = {float(t):g}; N = {N} over {ndev} devices; "
      f"state sharded on {len(u.sharding.device_set)} devices; "
      f"std = {float(jnp.std(u)):.3f}")
