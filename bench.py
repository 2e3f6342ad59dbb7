#!/usr/bin/env python
"""BASELINE.json benchmark suite on the attached device.

Emits one JSON line per benchmark.  The headline metric (config 3, KS
N=1e6 RODASPR implicit stepping — the BASELINE target of >1e9
cell-updates/sec on one chip) is emitted LAST so tooling that records the
final line as the round's result captures the headline, not the weakest
config.  The other configs, in emission order:

1. config 3 scaling — KS at N=1e4/1e5 (us/step at small N).
2. config 3 adaptive — the device-resident adaptive controller
   (tol=1e-3); value = N x internal attempts / wall.
3. config 5 — 1024-member KS ensemble at N=1e5, vmapped members
   (aggregate cell-updates/sec).
4. small-member sweep — B=64 x N=200 (launch-bound).
5. config 2 — Burgers N=1e6, backward-Euler (Theta) implicit steps.
6. config 4 — coupled falling-film h/q (block-banded J, upwind) RODASPR.
7. config 1 — README advection-diffusion, Theta + Dirichlet hook, N=200
   (dispatch-bound; measures the scan-chunked small-problem path).
8. config 3 headline — KS N=1e6 (LAST; ``vs_baseline`` = value / 1e9).

A df64 precision point (double-float KS at N=1e6, ``vs_baseline`` =
value / 1e7 — the 10x-over-emulated-f64 target) runs just before the
headline.

Environment knobs: BENCH_N, BENCH_STEPS, BENCH_REPEATS, BENCH_ONLY
(comma-separated subset of {ks,ks_scaling,ks_adaptive,ensemble,burgers,
film,advdiff,sweep,df64_smalln,df64_ensemble,df64}).
"""

import json
import os
import sys
import time
import traceback

import numpy as np

from triflow_jax.utils.compile_cache import enable_compile_cache

DT = 0.05

enable_compile_cache()

_hbm_measured = None


def _hbm_sustained_gbs():
    """Sustained HBM bandwidth of the ATTACHED device, measured in-run by a
    2-array triad stream (c = 0.999*c + a over ~0.8 GB: 3 arrays of
    device-memory traffic per pass).  Measured once per process;
    BENCH_HBM_GBS overrides."""
    global _hbm_measured
    if _hbm_measured is not None:
        return _hbm_measured
    forced = os.environ.get("BENCH_HBM_GBS")
    if forced:
        _hbm_measured = float(forced)
        return _hbm_measured
    import jax
    import jax.numpy as jnp

    n = 64 * 1024 * 1024   # 256 MB per f32 array
    # two scan lengths, rate from the DIFFERENCE: the fixed per-call cost
    # (dispatch + completion wait) cancels
    it1, it2 = 32, 160
    a = jnp.ones((n,), jnp.float32)

    def make(iters):
        @jax.jit
        def stream(c, a):
            # c <- 0.999*c + a per iteration: 2 reads + 1 write, and the
            # carried update keeps XLA from hoisting the body
            def body(c, _):
                return c * np.float32(0.999) + a, ()
            return jax.lax.scan(body, c, length=iters)[0]
        return stream

    s1, s2 = make(it1), make(it2)
    c = s2(s1(a, a), a).block_until_ready()
    best = 0.0
    for _ in range(3):
        start = time.perf_counter()
        c = s1(c, a).block_until_ready()
        t1 = time.perf_counter() - start
        start = time.perf_counter()
        c = s2(c, a).block_until_ready()
        t2 = time.perf_counter() - start
        if t2 > t1:
            best = max(best, 3 * 4 * n * (it2 - it1) / (t2 - t1))
    if not best:
        raise RuntimeError("bandwidth stream measurement failed")
    _hbm_measured = best / 1e9
    return _hbm_measured


def _row_step_bytes(N, nvar, halo, stages, item=4):
    """Estimated device-memory bytes per implicit ROW step under a no-reuse
    model (every major array goes to memory between kernels): factor write
    (fac/Dhinv/DU = 3 s^2 M), the stencil read of the state, per-stage
    factor re-read + rhs/k traffic, and the final stage combination.
    Theta is the stages=1 case.  An upper bound on real traffic: above
    100% of the measured stream rate the working set is (partly) held in
    cache."""
    g = max(halo, 1)
    s = nvar * g
    M = -(-N // g)
    factor = 3 * s * s * M                 # fac/Dhinv/DU written once
    reads_u = (2 * halo + 1) * nvar * N    # stencil read of the state
    per_stage = 3 * s * s * M + 3 * nvar * N  # factor re-read, rhs, k
    combine = (stages + 2) * nvar * N      # k_i reads + u read/write
    return item * (factor + reads_u + stages * per_stage + combine)


def _emit(metric, value, n_cells, steps, extra=None, bytes_per_step=None):
    import jax

    rec = {
        "metric": metric,
        "value": round(value, 1),
        "unit": "cells/s",
        "vs_baseline": round(value / 1e9, 4),
        "cells": int(n_cells),
        "steps_timed": steps,
        "device": str(jax.devices()[0]),
    }
    if bytes_per_step is not None:
        # steps/s = cells/s / cells-per-step; GB/s implied by the byte model
        steps_per_s = value / max(n_cells, 1)
        gbs = bytes_per_step * steps_per_s / 1e9
        hbm = _hbm_sustained_gbs()
        pct = round(100.0 * gbs / hbm, 1)
        rec["bytes_per_step"] = int(bytes_per_step)
        rec["hbm_sustained_gbs"] = round(hbm, 1)
        rec["pct_roofline"] = pct
    rec.update(extra or {})
    print(json.dumps(rec), flush=True)


def _time_chunks(run_chunk, state, repeats, work_per_chunk):
    """Best-of-repeats throughput of run_chunk(state) -> state."""
    import jax

    state = run_chunk(*state)          # warmup / compile
    jax.block_until_ready(state[-1])
    best = 0.0
    for _ in range(repeats):
        start = time.perf_counter()
        state = run_chunk(*state)
        jax.block_until_ready(state[-1])
        best = max(best, work_per_chunk / (time.perf_counter() - start))
    return best, state


def _ks_throughput(N, STEPS, REPEATS, double=False):
    """Best-of-repeats cell-updates/s of KS RODASPR fixed implicit steps at
    grid size N, a scan of STEPS steps per device call."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes

    if double:
        jax.config.update("jax_enable_x64", True)

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double=double)
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None)
    fixed = scheme.device_fixed_step(periodic=True)

    dtype = model.backend.dtype
    # production-scale KS: fixed resolution dx = 0.5, domain grows with N
    # (resolving a small domain at dx ~ 1e-4 would make I - gamma*dt*J
    # condition ~1e15 -- not a meaningful workload at any precision)
    x = jnp.asarray(np.arange(N, dtype=np.float64) * 0.5, dtype)
    rng = np.random.RandomState(0)
    u0 = jnp.asarray(
        (np.cos(2 * np.pi * np.arange(N) / N * 10)
         + 0.1 * rng.randn(N)).astype(np.float32)[None],
        dtype,
    )
    helpers = jnp.zeros((0, N), dtype)
    pstack = jnp.zeros((0, N), dtype)

    def chain(carry, _):
        t, u = carry
        u2, _h, _p, _x, _err = fixed(t, u, helpers, pstack, x, DT)
        return (t + DT, u2), ()

    @jax.jit
    def run_chunk(t, u):
        return jax.lax.scan(chain, (t, u), length=STEPS)[0]

    best, (t, u) = _time_chunks(run_chunk, (jnp.asarray(0.0, dtype), u0),
                                REPEATS, N * STEPS)
    if not bool(jnp.isfinite(u).all()):
        raise RuntimeError("non-finite state")
    return best


def bench_ks():
    """Config 3: KS at N=1e6, RODASPR fixed implicit steps (the headline
    BASELINE metric)."""
    N = int(os.environ.get("BENCH_N", 1_000_000))
    STEPS = int(os.environ.get("BENCH_STEPS", 500))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    double = bool(int(os.environ.get("BENCH_DOUBLE", "0")))
    best = _ks_throughput(N, STEPS, REPEATS, double=double)
    _emit("ks-implicit-cell-updates", best, N, STEPS, {"N": N},
          bytes_per_step=_row_step_bytes(N, 1, 2, 6))


def bench_ks_scaling():
    """BASELINE metric's scaling dimension: cell-updates/s and wall-time
    per implicit step at KS N=1e4 and 1e5 (N=1e6 is the headline line).
    Steps per device call scale inversely with N so device work stays
    ~O(100ms) and the per-call dispatch is amortized at every size."""
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    for N, steps in ((10_000, 20_000), (100_000, 4_000)):
        best = _ks_throughput(N, steps, REPEATS)
        _emit("ks-scaling-cell-updates", best, N, steps,
              {"N": N, "us_per_step": round(N / best * 1e6, 2)},
              bytes_per_step=_row_step_bytes(N, 1, 2, 6))


def bench_ks_adaptive():
    """Config 3, adaptive variant: KS at N=1e6 under the device-resident
    RODASPR controller (tol=1e-3).  Measures internal-ATTEMPT throughput:
    several output steps are scanned in one device call (amortizing the
    per-call dispatch) and the controller's own niter counters are summed, so
    value = N * attempts / wall.  An attempt is one full ROW step (J +
    factor + 6 stage solves) — the adaptive loop's only overhead over the
    fixed-dt scan is the embedded-error combination and the accept/reject
    masking, both measured in the noise (~1%)."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes

    N = int(os.environ.get("BENCH_N", 1_000_000))
    M = int(os.environ.get("BENCH_ADAPT_OUTSTEPS", 60))
    OUT_DT = float(os.environ.get("BENCH_ADAPT_DT", 1.0))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))

    model = Model("-dxxU - dxxxxU - U * dxU", "U")
    scheme = schemes.RODASPR(model, time_stepping=True, tol=1e-3)
    stepper = scheme.device_stepper(periodic=True)

    dtype = model.backend.dtype
    x = jnp.asarray(np.arange(N, dtype=np.float64) * 0.5, dtype)
    rng = np.random.RandomState(0)
    u0 = jnp.asarray(
        (np.cos(2 * np.pi * np.arange(N) / N * 10)
         + 0.1 * rng.randn(N)).astype(np.float32)[None],
        dtype,
    )
    helpers = jnp.zeros((0, N), dtype)
    pstack = jnp.zeros((0, N), dtype)

    @jax.jit
    def run_chunk(t, u, internal_dt):
        def body(carry, _):
            t_, u_, dti = carry
            t2, u2, _h, _p, _x, dti2, ni, st = stepper(
                t_, u_, helpers, pstack, x,
                jnp.asarray(OUT_DT, dtype), dti)
            return (t2, u2, dti2), (ni, st)
        (t2, u2, dti2), (nis, sts) = jax.lax.scan(
            body, (t, u, internal_dt), length=M)
        return t2, u2, dti2, jnp.sum(nis), jnp.max(sts)

    state = (jnp.asarray(0.0, dtype), u0, jnp.asarray(0.05, dtype))
    t, u, dti, niter, status = run_chunk(*state)     # warmup / compile
    jax.block_until_ready(u)
    if int(status) != 0:
        raise RuntimeError(f"adaptive controller status={int(status)}")
    best, attempts = 0.0, 0
    for _ in range(REPEATS):
        start = time.perf_counter()
        t, u, dti, niter, status = run_chunk(t, u, dti)
        jax.block_until_ready(u)
        elapsed = time.perf_counter() - start
        ni = int(niter)
        if ni * N / elapsed > best:
            best, attempts = ni * N / elapsed, ni
    if not bool(jnp.isfinite(u).all()):
        raise RuntimeError("non-finite state")
    _emit("ks-adaptive-cell-updates", best, N, attempts,
          {"N": N, "tol": 1e-3, "attempts_timed": attempts,
           "out_steps": M},
          bytes_per_step=_row_step_bytes(N, 1, 2, 6))


def bench_ensemble():
    """Config 5 at spec scale: B=1024 KS members, N=1e5 each, stepped
    together (vmapped members)."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble

    B = int(os.environ.get("BENCH_ENSEMBLE_B", 1024))
    N = int(os.environ.get("BENCH_ENSEMBLE_N", 100_000))
    STEPS = int(os.environ.get("BENCH_ENSEMBLE_STEPS", 50))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double=False)
    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(1)
    phases = rng.rand(B, 1) * 2 * np.pi
    u0 = (np.cos(2 * np.pi * np.arange(N)[None] / N * 10 + phases)
          + 0.1 * rng.randn(B, N)).astype(np.float32)
    ens = Ensemble(model, u0, dict(periodic=True), x,
                   scheme=schemes.RODASPR, time_stepping=False, tol=None)

    ens.steps(STEPS, DT)              # warmup / compile
    jax.block_until_ready(ens.u)
    best = 0.0
    for _ in range(REPEATS):
        start = time.perf_counter()
        ens.steps(STEPS, DT)
        jax.block_until_ready(ens.u)
        best = max(best, B * N * STEPS / (time.perf_counter() - start))
    if not bool(jnp.isfinite(ens.u).all()):
        raise RuntimeError("non-finite state")
    _emit("ks-ensemble-cell-updates", best, B * N, STEPS,
          {"B": B, "N": N},
          bytes_per_step=B * _row_step_bytes(N, 1, 2, 6))


def bench_sweep():
    """Small-member parameter sweep (the reference's flagship use-case,
    user_guide.rst:125-138): B=64 KS instances at N=200, fixed-dt RODASPR.
    Launch-bound.  Chained calls pipeline dispatch with compute, so the
    metric times a block of calls end-to-end."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble

    B = int(os.environ.get("BENCH_SWEEP_B", 64))
    N = int(os.environ.get("BENCH_SWEEP_N", 200))
    STEPS = int(os.environ.get("BENCH_SWEEP_STEPS", 1000))
    CALLS = int(os.environ.get("BENCH_SWEEP_CALLS", 5))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double=False)
    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(2)
    phases = rng.rand(B, 1) * 2 * np.pi
    u0 = (np.cos(2 * np.pi * np.arange(N)[None] / N * 5 + phases)
          + 0.1 * rng.randn(B, N)).astype(np.float32)
    ens = Ensemble(model, u0, dict(periodic=True), x,
                   scheme=schemes.RODASPR, time_stepping=False, tol=None)
    ens.steps(STEPS, DT)                # warmup / compile
    ens.steps(STEPS, DT)
    np.asarray(ens.u)
    best = 0.0
    for _ in range(REPEATS):
        start = time.perf_counter()
        for _c in range(CALLS):
            ens.steps(STEPS, DT)
        u_host = np.asarray(ens.u)
        best = max(best, B * N * STEPS * CALLS
                   / (time.perf_counter() - start))
    if not bool(np.isfinite(u_host).all()):
        raise RuntimeError("non-finite state")
    _emit("ks-sweep-cell-updates", best, B * N, STEPS * CALLS,
          {"B": B, "N": N,
           "us_per_step": round(B * N / best * 1e6, 2)},
          bytes_per_step=B * _row_step_bytes(N, 1, 2, 6))


def bench_df64():
    """Precision point: KS RODASPR fixed steps in df64 (double-float
    (hi, lo) f32 pairs — ops/df64.py) at N=1e6, with the recommended
    mixed-precision stage solves (f32-factorization preconditioner + one
    df64-residual refinement pass, ``df64_mixed_solve=1``).
    vs_baseline here = value / 1e7.
    BENCH_DF64_FULL=1 benches the full-df64 solver instead (~7e6)."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes
    from triflow_jax.ops.df64 import DF

    N = int(os.environ.get("BENCH_DF64_N", 1_000_000))
    STEPS = int(os.environ.get("BENCH_DF64_STEPS", 20))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    mixed = 0 if os.environ.get("BENCH_DF64_FULL") else 1
    DTX = 0.0625

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double="df64")
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None,
                             df64_mixed_solve=mixed)
    fixed = scheme.device_fixed_step(periodic=True)

    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(0)
    u0 = (np.cos(2 * np.pi * np.arange(N) / N * 10)
          + 0.1 * rng.randn(N))[None]
    u = DF.from_float64(u0)
    h = DF.from_float64(np.zeros((0, N)))
    p = DF.from_float64(np.zeros((0, N)))
    xx = DF.from_float64(x)

    def chain(carry, _):
        t, u_ = carry
        u2, *_ = fixed(t, u_, h, p, xx, jnp.float32(DTX))
        return (t + DTX, u2), ()

    @jax.jit
    def run_chunk(t, u_):
        return jax.lax.scan(chain, (t, u_), length=STEPS)[0]

    t, u = run_chunk(jnp.float32(0.0), u)      # warmup / compile
    jax.block_until_ready(u.hi)
    best = 0.0
    for _ in range(REPEATS):
        start = time.perf_counter()
        t, u = run_chunk(t, u)
        jax.block_until_ready(u.hi)
        best = max(best, N * STEPS / (time.perf_counter() - start))
    if not bool(jnp.isfinite(u.hi).all()):
        raise RuntimeError("non-finite state")
    bytes_per_step = _row_step_bytes(N, 1, 2, 6, item=8)
    steps_per_s = best / N
    hbm = _hbm_sustained_gbs()
    rec = {
        "metric": "ks-df64-cell-updates", "value": round(best, 1),
        "unit": "cells/s", "vs_baseline": round(best / 1e7, 4),
        "cells": N, "steps_timed": STEPS, "N": N,
        "device": str(jax.devices()[0]),
        "precision": "df64",
        "solver": "mixed-n1" if mixed else "full-df64",
        "bytes_per_step": int(bytes_per_step),
        "hbm_sustained_gbs": round(hbm, 1),
        "pct_roofline": round(
            100.0 * bytes_per_step * steps_per_s / 1e9 / hbm, 1),
    }
    print(json.dumps(rec), flush=True)


def bench_df64_smalln():
    """df64 small-N latency point (VERDICT r3 next-round #9): the
    launch/serial-depth regime of the PRECISION path, N=1e4 KS RODASPR
    fixed df64 steps — us/step is the metric."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes
    from triflow_jax.ops.df64 import DF

    N = int(os.environ.get("BENCH_DF64_SMALL_N", 10_000))
    STEPS = int(os.environ.get("BENCH_DF64_SMALL_STEPS", 200))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    DTX = 0.0625

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double="df64")
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None,
                             df64_mixed_solve=1)

    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(0)
    u0 = (np.cos(2 * np.pi * np.arange(N) / N * 10)
          + 0.1 * rng.randn(N))[None]
    u = DF.from_float64(u0)
    h = DF.from_float64(np.zeros((0, N)))
    p = DF.from_float64(np.zeros((0, N)))
    xx = DF.from_float64(x)

    fixed = scheme.device_fixed_step(periodic=True)

    def chain(carry, _):
        t, u_ = carry
        u2, *_ = fixed(t, u_, h, p, xx, jnp.float32(DTX))
        return (t + DTX, u2), ()

    @jax.jit
    def run_chunk(t, u_):
        return jax.lax.scan(chain, (t, u_), length=STEPS)[0]

    t, u = run_chunk(jnp.float32(0.0), u)      # warmup / compile
    jax.block_until_ready(u.hi)
    best = 0.0
    for _ in range(REPEATS):
        start = time.perf_counter()
        t, u = run_chunk(t, u)
        jax.block_until_ready(u.hi)
        best = max(best, N * STEPS / (time.perf_counter() - start))
    if not bool(jnp.isfinite(u.hi).all()):
        raise RuntimeError("non-finite state")
    rec = {
        "metric": "ks-df64-smalln-cell-updates", "value": round(best, 1),
        "unit": "cells/s", "vs_baseline": round(best / 1e7, 4),
        "cells": N, "steps_timed": STEPS, "N": N,
        "us_per_step": round(N / best * 1e6, 2),
        "device": str(jax.devices()[0]),
        "precision": "df64", "solver": "mixed-n1",
    }
    print(json.dumps(rec), flush=True)


def bench_df64_ensemble():
    """df64 ensemble throughput: B=64 x N=1e5 KS members in double-float
    (vmapped members, mixed-precision stage solves).  vs_baseline = value /
    1e7 (same scale as the single-grid df64 point)."""
    import jax

    from triflow_jax import Model, schemes
    from triflow_jax.parallel import Ensemble
    from triflow_jax.ops.df64 import DF

    B = int(os.environ.get("BENCH_DF64_ENS_B", 64))
    N = int(os.environ.get("BENCH_DF64_ENS_N", 100_000))
    STEPS = int(os.environ.get("BENCH_DF64_ENS_STEPS", 10))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    DTX = 0.05

    model = Model("-dxxU - dxxxxU - U * dxU", "U", double="df64")
    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(1)
    phases = rng.rand(B, 1) * 2 * np.pi
    u0 = (np.cos(2 * np.pi * np.arange(N)[None] / N * 10 + phases)
          + 0.1 * rng.randn(B, N))

    def run(ens, steps):
        ens.steps(steps, DTX)            # warmup / compile
        jax.block_until_ready(ens.u.hi)
        top = 0.0
        for _ in range(REPEATS):
            start = time.perf_counter()
            ens.steps(steps, DTX)
            jax.block_until_ready(ens.u.hi)
            top = max(top, B * N * steps / (time.perf_counter() - start))
        if not bool(np.isfinite(np.asarray(ens.u.hi)).all()):
            raise RuntimeError("non-finite state")
        return top

    ens = Ensemble(model, u0, dict(periodic=True), x,
                   scheme=schemes.RODASPR, time_stepping=False, tol=None,
                   df64_mixed_solve=1)
    best = run(ens, STEPS)
    rec = {
        "metric": "ks-df64-ensemble-cell-updates", "value": round(best, 1),
        "unit": "cells/s", "vs_baseline": round(best / 1e7, 4),
        "cells": B * N, "steps_timed": STEPS, "B": B, "N": N,
        "device": str(jax.devices()[0]),
        "precision": "df64", "solver": "mixed-n1",
    }
    print(json.dumps(rec), flush=True)


def bench_burgers():
    """Config 2: Burgers at N=1e6, backward-Euler (Theta, linearized) —
    banded J eval + factor + solve per step."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes

    N = int(os.environ.get("BENCH_N", 1_000_000))
    STEPS = int(os.environ.get("BENCH_BURGERS_STEPS", 200))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))

    model = Model("-U * dxU + nu * dxxU", "U", "nu", double=False)
    scheme = schemes.Theta(model, theta=1.0)
    dtype = model.backend.dtype
    x = jnp.asarray(np.arange(N, dtype=np.float64) * 0.5, dtype)
    u0 = jnp.asarray(np.cos(2 * np.pi * np.arange(N) / N * 4,
                            dtype=np.float64)[None], dtype)
    helpers = jnp.zeros((0, N), dtype)
    pstack = model.backend.pack_pars(dict(nu=0.5, periodic=True), x)

    fixed = scheme.device_fixed_step(periodic=True)

    def chain(carry, _):
        t, u = carry
        u2, *_ = fixed(t, u, helpers, pstack, x, DT)
        return (t + DT, u2), ()

    @jax.jit
    def run_chunk(t, u):
        return jax.lax.scan(chain, (t, u), length=STEPS)[0]

    best, (t, u) = _time_chunks(run_chunk, (jnp.asarray(0.0, dtype), u0),
                                REPEATS, N * STEPS)
    if not bool(jnp.isfinite(u).all()):
        raise RuntimeError("non-finite state")
    _emit("burgers-theta-cell-updates", best, N, STEPS, {"N": N},
          bytes_per_step=_row_step_bytes(N, 1, 1, 1))


def bench_film():
    """Config 4: coupled falling-film h/q model (2 variables, upwind halo-2
    stencil, block-banded J) under fixed-dt RODASPR."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes

    N = int(os.environ.get("BENCH_FILM_N", 262_144))
    STEPS = int(os.environ.get("BENCH_FILM_STEPS", 1000))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    dt = 0.01

    model = Model(
        ["-dxq",
         "9/7 * q**2 / h**2 * dxh - upwind(17/7 * q / h, q, 2)"
         " + (h - q / h**2) / delta"],
        ["h", "q"], ["delta"], double=False,
    )
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None)
    fixed = scheme.device_fixed_step(periodic=True)
    dtype = model.backend.dtype
    # fixed resolution (dx as in the regression workload), domain grows
    # with N — same scaling policy as the KS bench
    L = N * (100.0 / 256.0)
    x = jnp.asarray(np.linspace(0, L, N, endpoint=False), dtype)
    waves = max(3 * N // 256, 1)
    h0 = 1 + 0.1 * np.cos(2 * np.pi * np.arange(N) / N * waves)
    u0 = jnp.asarray(np.stack([h0, h0 ** 3 / 3]), dtype)
    helpers = jnp.zeros((0, N), dtype)
    pstack = model.backend.pack_pars(dict(delta=0.3, periodic=True), x)

    def chain(carry, _):
        t, u = carry
        u2, *_ = fixed(t, u, helpers, pstack, x, dt)
        return (t + dt, u2), ()

    @jax.jit
    def run_chunk(t, u):
        return jax.lax.scan(chain, (t, u), length=STEPS)[0]

    best, (t, u) = _time_chunks(run_chunk, (jnp.asarray(0.0, dtype), u0),
                                REPEATS, 2 * N * STEPS)
    if not bool(jnp.isfinite(u).all()):
        raise RuntimeError("non-finite state")
    _emit("film-rodaspr-cell-updates", best, 2 * N, STEPS, {"N": N},
          bytes_per_step=_row_step_bytes(N, 2, 2, 6))


def bench_advdiff():
    """Config 1: README advection-diffusion (N=200, Theta, Dirichlet hook)
    — dominated by per-step dispatch; measures the scanned small-problem
    path end to end (hook traced into the step)."""
    import jax
    import jax.numpy as jnp

    from triflow_jax import Model, schemes

    N = 200
    STEPS = int(os.environ.get("BENCH_ADVDIFF_STEPS", 5000))
    REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
    dt = 5.0

    model = Model("k * dxxU - c * dxU", "U", ["k", "c"], double=False)

    def dirichlet(t, fields, pars):
        fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
        return fields, pars

    scheme = schemes.Theta(model, theta=1.0)
    stepper = scheme.device_stepper(hook=dirichlet, periodic=False)
    dtype = model.backend.dtype
    x = jnp.asarray(np.linspace(0, 1, N), dtype)
    u0 = jnp.asarray(np.cos(2 * np.pi * np.linspace(0, 1, N) * 5)[None],
                     dtype)
    helpers = jnp.zeros((0, N), dtype)
    pstack = model.backend.pack_pars(dict(k=1e-3, c=3e-3, periodic=False), x)

    def chain(carry, _):
        t, u = carry
        t2, u2, *_ = stepper(t, u, helpers, pstack, x, dt, dt)
        return (t2, u2), ()

    @jax.jit
    def run_chunk(t, u):
        return jax.lax.scan(chain, (t, u), length=STEPS)[0]

    best, (t, u) = _time_chunks(run_chunk, (jnp.asarray(0.0, dtype), u0),
                                REPEATS, N * STEPS)
    if not bool(jnp.isfinite(u).all()):
        raise RuntimeError("non-finite state")
    _emit("advdiff-theta-cell-updates", best, N, STEPS, {"N": N},
          bytes_per_step=_row_step_bytes(N, 1, 1, 1))


# The headline bench runs LAST so the final emitted line IS the headline
# metric (downstream tooling records the last line as the round's result).
BENCHES = [
    ("ks_scaling", bench_ks_scaling),
    ("ks_adaptive", bench_ks_adaptive),
    ("ensemble", bench_ensemble),
    ("sweep", bench_sweep),
    ("burgers", bench_burgers),
    ("film", bench_film),
    ("advdiff", bench_advdiff),
    ("df64_smalln", bench_df64_smalln),
    ("df64_ensemble", bench_df64_ensemble),
    ("df64", bench_df64),
    ("ks", bench_ks),
]


def main():
    only = os.environ.get("BENCH_ONLY")
    selected = {s.strip() for s in only.split(",")} if only else None
    rc = 0
    for name, fn in BENCHES:
        if selected is not None and name not in selected:
            continue
        try:
            fn()
        except Exception as err:  # keep the remaining benches alive
            print(json.dumps({"metric": name, "value": 0.0,
                              "unit": "cells/s", "vs_baseline": 0.0,
                              "error": f"{type(err).__name__}: {err}"}),
                  flush=True)
            traceback.print_exc(file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
