"""df64 step decomposition on the attached device: where the time of a
double-float RODASPR step goes.

Times each component of the mixed-n1 df64 RODASPR step at BENCH scale and
prints one JSON line per component: F_df64 eval, J_bands_df64 eval, the
f32 factorization of the rounded system, the f32 preconditioner solve,
the df64 residual matvec, and the assembled fixed step.  Components are
scanned STEPS times per device call (dispatch amortization) and best-of-3
timed.

Run from the repo root:
    python tools/profile_df64.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes
    from triflow_jax.ops.banded import factor_linearized
    from triflow_jax.ops.banded_df import axpy_bands_df, banded_matvec_df
    from triflow_jax.ops.df64 import DF
    from triflow_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    N = int(os.environ.get("PROF_N", 1_000_000))
    STEPS = int(os.environ.get("PROF_STEPS", 10))
    DTX = 0.0625

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double="df64")
    be = model.backend
    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(0)
    u0 = (np.cos(2 * np.pi * np.arange(N) / N * 10)
          + 0.1 * rng.randn(N))[None]
    u = DF.from_float64(u0)
    h = DF.from_float64(np.zeros((0, N)))
    p = DF.from_float64(np.zeros((0, N)))
    xx = DF.from_float64(x)
    g00 = 0.25
    gdt = DF(np.float32(g00)) * DF(jnp.float32(DTX))

    def timed(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        per = best / STEPS
        print(json.dumps({"component": name, "ms": round(per * 1e3, 3),
                          "cells_per_s": round(N / per, 1)}), flush=True)
        return per

    # 1. df64 F eval
    @jax.jit
    def run_F(u):
        def body(c, _):
            F = be.F_df64(c, h, p, xx, periodic=True)
            return c + DF(jnp.float32(1e-6)) * F, ()
        return jax.lax.scan(body, u, length=STEPS)[0].hi

    t_F = timed("F_df64", run_F, u)

    # 2. df64 J eval (consume via a cheap reduction to keep it live)
    @jax.jit
    def run_J(u):
        def body(c, _):
            J = be.J_bands_df64(c, h, p, xx, periodic=True)
            s = jnp.sum(J.hi[..., 0]) * 1e-20
            return c + DF(s.astype(jnp.float32)), ()
        return jax.lax.scan(body, u, length=STEPS)[0].hi

    t_J = timed("J_bands_df64", run_J, u)

    # materialize one J for the solver pieces
    J = jax.jit(lambda u: be.J_bands_df64(u, h, p, xx, periodic=True))(u)
    A_df = jax.jit(lambda J: axpy_bands_df(1.0, -gdt, J))(J)
    jax.block_until_ready(A_df.hi)
    J32 = jax.jit(lambda J: J.hi + J.lo)(J)

    rhs_probe = jnp.asarray(u0, jnp.float32)

    # 3. f32 factorization of the rounded system
    @jax.jit
    def run_fact(J32):
        def body(c, _):
            f = factor_linearized(1.0, -g00 * DTX, J32 + c * 0.0, True)
            return c + jnp.sum(f.solve(rhs_probe)[..., :1]) * 1e-20, ()
        return jax.lax.scan(body, jnp.float32(0.0), length=STEPS)[0]

    t_fact = timed("f32_factor+1solve", run_fact, J32)

    # 4. f32 solve alone (factor once outside)
    fact32 = jax.jit(
        lambda J32: factor_linearized(1.0, -g00 * DTX, J32, True)
    )(J32)
    jax.block_until_ready(jax.tree_util.tree_leaves(fact32)[0])
    rhs32 = jnp.asarray(u0, jnp.float32)

    @jax.jit
    def run_solve(rhs):
        def body(c, _):
            return fact32.solve(c), ()
        return jax.lax.scan(body, rhs, length=STEPS)[0]

    t_solve = timed("f32_solve", run_solve, rhs32)

    # 5. df64 residual matvec
    @jax.jit
    def run_mv(k):
        def body(c, _):
            r = banded_matvec_df(A_df, c, True)
            return c + DF(jnp.float32(1e-20)) * r, ()
        return jax.lax.scan(body, k, length=STEPS)[0].hi

    t_mv = timed("df64_residual_matvec", run_mv, u)

    # 6. assembled mixed-n1 fixed step (the bench configuration)
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None,
                             df64_mixed_solve=1)
    fixed = scheme.device_fixed_step(periodic=True)

    @jax.jit
    def run_step(u):
        def body(c, _):
            u2, *_ = fixed(0.0, c, h, p, xx, jnp.float32(DTX))
            return u2, ()
        return jax.lax.scan(body, u, length=STEPS)[0].hi

    t_step = timed("mixed_n1_step", run_step, u)

    s = 6
    model_sum = (t_F * s + t_J + t_fact + t_solve * 2 * s + t_mv * s)
    print(json.dumps({
        "component": "decomposition",
        "step_ms": round(t_step * 1e3, 2),
        "sum_of_parts_ms": round(model_sum * 1e3, 2),
        "parts": {
            "6x F": round(t_F * s * 1e3, 2),
            "J": round(t_J * 1e3, 2),
            "factor": round(t_fact * 1e3, 2),
            "12x f32 solve": round(t_solve * 2 * s * 1e3, 2),
            "6x residual matvec": round(t_mv * s * 1e3, 2),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
