#!/usr/bin/env python
"""Smoke test of the main path on one NVIDIA GPU (or four, with --four).

Drives the public API — ``Model`` from a string, ``Simulation`` with the
Rosenbrock and Theta schemes, ``Ensemble`` and spatial sharding — at full
grid sizes, and checks every result against a plain reference: the NumPy
oracle backend for F and J, scipy's sparse LU for the banded solve, float64
runs for float32 trajectories, and CPU float64 for df64 and small grids.
The chunked-Thomas sweep kernels (ops/sweeps.py) run as compiled for the
card and are compared with the ``lax.scan`` sweeps.

Each phase prints one JSON line: the card, set-up (compile + first run)
and run seconds, peak device memory, and every check as its error beside
its tolerance and the reason for that tolerance.  A failed check stops the
script with a non-zero exit.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py           # one card, all single-card phases
    python chip_smoke.py --four    # the four-card paths and their references

Without a GPU the script exits non-zero before any phase runs.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse.linalg as spla

import triflow_jax as triflow
from triflow_jax import schemes
from triflow_jax.core.compiler import bands_to_csc
from triflow_jax.core.symbolic import (centered_stencil_coefficients,
                                       stencil_half_width)
from triflow_jax.parallel import Ensemble

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
EPS_DF64 = 2.0 ** -48          # double-float significand (~49 bits)

KS = "-dxxU - dxxxxU - U * dxU"
BURGERS = "-U * dxU + nu * dxxU"
DX = 0.5                        # fixed resolution: the domain grows with N
GAMMA = 0.25                    # RODASPR diagonal coefficient
RODASPR_STAGES = 6


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Phase:
    """Collects the checks and timings of one phase and prints its line."""

    def __init__(self, name, card):
        self.name, self.card = name, card
        self.checks, self.info = [], {}
        self.setup_s = self.run_s = 0.0

    def check(self, what, err, tol, reason):
        err, tol = float(err), float(tol)
        self.checks.append(dict(check=what, err=err, tol=tol, reason=reason,
                                ok=bool(np.isfinite(err) and err <= tol)))

    def done(self):
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        ok = all(c["ok"] for c in self.checks)
        print(json.dumps(dict(
            phase=self.name, card=self.card, ok=ok, setup_s=self.setup_s,
            run_s=self.run_s, peak_bytes=stats.get("peak_bytes_in_use"),
            checks=self.checks, **self.info)), flush=True)
        if not ok:
            bad = [c["check"] for c in self.checks if not c["ok"]]
            raise SystemExit(f"phase {self.name} failed: {bad}")


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# references and error bounds
# ---------------------------------------------------------------------------

def stencil_abs(a, order, periodic=True):
    """sum_j |w_j| |a_{i+j}| / dx^order for the centred stencil of order."""
    w = centered_stencil_coefficients(order, stencil_half_width(order))
    out = np.zeros_like(a)
    for k, c in w.items():
        sh = np.roll(a, -k) if periodic else np.take(
            a, np.clip(np.arange(a.size) + k, 0, a.size - 1))
        out += abs(float(c)) * sh
    return out / DX ** order


def ks_magnitude(U):
    """Largest sum of |terms| in the KS right-hand side: the f32 rounding of
    F is eps times this amplification (dxxxx alone weighs 16/dx^4)."""
    a = np.abs(U)
    return float(np.max(stencil_abs(a, 2) + stencil_abs(a, 4)
                        + a * stencil_abs(a, 1)))


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-300)


def kappa_inf(csc):
    """||A||_inf ||A^-1||_inf, the second from scipy's 1-norm estimator on
    A^T (one sparse LU)."""
    lu = spla.splu(csc.T.tocsc())
    n = csc.shape[0]
    inv_t = spla.LinearOperator((n, n), matvec=lu.solve,
                                rmatvec=lambda v: lu.solve(v, trans="T"),
                                dtype=np.float64)
    norm_a = abs(csc).sum(axis=1).max()
    return float(norm_a * spla.onenormest(inv_t)), lu


def system_csc(J, beta, periodic):
    """alpha*I + beta*J with alpha = 1, on the host in float64."""
    from triflow_jax.ops.banded import axpy_bands

    A = np.asarray(axpy_bands(1.0, beta, np.asarray(J, np.float64)))
    return bands_to_csc(A, periodic).tocsc()


def ks_fields(model, N, seed=0):
    x = np.arange(N, dtype=np.float64) * DX
    rng = np.random.RandomState(seed)
    U = np.cos(2 * np.pi * np.arange(N) / N * 10) + 0.1 * rng.randn(N)
    return model.fields_template(x=x, U=U)


def device_arrays(model, fields, pars):
    be = model.backend
    u, h, x = be.split_fields(fields)
    return u, h, be.pack_pars(pars, x), x


def run_simulation(model, fields, pars, dt, n, **kw):
    """(final fields, set-up s, run s): the first output step (compile +
    run) is set-up, the remaining n-1 are the run."""
    import jax

    sim = triflow.Simulation(model, fields, pars, dt=dt, tmax=n * dt, **kw)
    it = iter(sim)
    t0 = time.perf_counter()
    next(it)                                      # initial state
    _t, f = next(it)
    jax.block_until_ready(f["U"])
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _t, f in it:
        pass
    jax.block_until_ready(f["U"])
    return f, setup, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_ks(card, N=1_000_000, dt=0.05, n=5):
    """Phases 1 and 2: the KS headline in float32 and at the package
    default float64, each F, J and one factor+solve against the host
    references; the f32 trajectory against the f64 one."""
    import jax
    from triflow_jax.ops.banded import factor_linearized

    pars = dict(periodic=True)
    oracle = triflow.Model(KS, "U", compiler="numpy")
    fields0 = ks_fields(oracle, N)
    U0 = np.asarray(fields0["U"], np.float64)
    S = ks_magnitude(U0)
    beta = -GAMMA * dt
    results = {}
    for double in (True, False):
        name = "ks-f64" if double else "ks-f32"
        eps = EPS64 if double else EPS32
        ph = Phase(name, card)
        model = triflow.Model(KS, "U", double=double)
        u, h, p, x = device_arrays(model, fields0, pars)
        be = model.backend
        F = be.F(u, h, p, x, periodic=True)
        J = be.J_bands(u, h, p, x, periodic=True)
        # the oracle sees the same (rounded) state the device holds
        uo = np.asarray(u, np.float64)
        xo = np.asarray(x, np.float64)
        F_ref = oracle.backend.F_impl(uo, np.zeros((0, N)), np.zeros((0, N)),
                                      xo, periodic=True)
        J_ref = oracle.backend.J_bands_impl(uo, np.zeros((0, N)),
                                            np.zeros((0, N)), xo,
                                            periodic=True)
        ph.check("F vs numpy oracle", np.max(np.abs(np.asarray(F) - F_ref)),
                 8 * eps * S, "8 roundings x eps x max_i sum|stencil terms| "
                 f"(={S:.4g}: dxxxx weighs 16/dx^4 at dx={DX})")
        Jmag = np.max(np.sum(np.abs(J_ref), axis=(0, 1, 2)))
        ph.check("J bands vs numpy oracle",
                 np.max(np.abs(np.asarray(J) - J_ref)), 8 * eps * Jmag,
                 f"8 roundings x eps x max row sum |J| (={Jmag:.4g})")

        csc = system_csc(J, beta, True)
        kappa, lu = kappa_inf(csc)
        rng = np.random.RandomState(1)
        b = rng.randn(1, N)
        solve = jax.jit(lambda J, b: factor_linearized(1.0, beta, J,
                                                       True).solve(b))
        bd = jax.numpy.asarray(b, be.dtype)
        xdev, ph.setup_s = timed(solve, J, bd)
        _, ph.run_s = timed(solve, J, bd)
        xref = lu.solve(np.asarray(bd, np.float64).T.flatten(), trans="T")
        ph.check("factor+solve vs scipy splu (f64 host)",
                 rel_err(np.asarray(xdev).T.flatten(), xref), 16 * eps * kappa,
                 f"16 eps x kappa_inf(I - gamma dt J) (={kappa:.4g}), "
                 "relative to max|x|")

        f, s_setup, s_run = run_simulation(
            model, fields0, pars, dt, n, scheme=schemes.RODASPR,
            time_stepping=False, tol=None)
        results[double] = np.asarray(f["U"], np.float64)
        ph.info.update(N=N, dt=dt, steps=n, kappa_inf=kappa,
                       simulation_setup_s=s_setup, simulation_run_s=s_run)
        if not double:
            growth = np.exp(0.25 * n * dt)   # KS linear growth rate <= 1/4
            tol = n * (RODASPR_STAGES + 1) * EPS32 * kappa * \
                np.max(np.abs(U0)) * growth
            ph.check("RODASPR trajectory f32 vs f64 on the card",
                     np.max(np.abs(results[False] - results[True])), tol,
                     "steps x (stages+1) x eps32 x kappa x max|U0| x "
                     "exp(t/4) (KS growth bound)")
        ph.check("trajectory finite", 0.0 if np.isfinite(results[double])
                 .all() else np.inf, 0.0, "no NaN/inf in the state")
        if double:
            f64_phase = ph
        else:
            ph.done()
    f64_phase.done()


def burgers_fields(model, N):
    x = np.arange(N, dtype=np.float64) * DX
    L = N * DX
    rng = np.random.RandomState(3)
    U = 0.5 * (1 - np.tanh((x - L / 4) / 10.0)) + 0.01 * rng.randn(N)
    U[0], U[-1] = 1.0, 0.0
    return model.fields_template(x=x, U=U)


def dirichlet(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    return fields, pars


def phase_burgers(card, N=1_000_000, N_small=10_000, dt=0.05, n=5):
    """Phase 3: non-periodic Burgers, backward-Euler Theta, traced
    Dirichlet hook (the non-cyclic solve path)."""
    import jax

    ph = Phase("burgers-theta-edge-hook", card)
    pars = dict(periodic=False, nu=0.5)
    kw = dict(scheme=schemes.Theta, theta=1.0, time_stepping=False,
              hook=dirichlet)
    runs = {}
    for double in (True, False):
        model = triflow.Model(BURGERS, "U", "nu", double=double)
        f, s, r = run_simulation(model, burgers_fields(model, N), pars, dt, n,
                                 **kw)
        runs[double] = np.asarray(f["U"], np.float64)
        if not double:
            ph.setup_s, ph.run_s = s, r
    oracle = triflow.Model(BURGERS, "U", "nu", compiler="numpy")
    f0 = burgers_fields(oracle, N)
    U0 = np.asarray(f0["U"], np.float64)
    J0 = oracle.backend.J_bands_impl(U0[None], np.zeros((0, N)),
                                     np.full((1, N), 0.5), f0["x"],
                                     periodic=False)
    kappa, _ = kappa_inf(system_csc(J0, -dt, False))
    ph.check("N=1e6 f32 vs f64 on the card",
             np.max(np.abs(runs[False] - runs[True])),
             n * 2 * EPS32 * kappa * np.max(np.abs(U0)),
             f"steps x 2 x eps32 x kappa_inf(I - dt J) (={kappa:.4g}) x "
             "max|U0| (Burgers is non-expansive in max norm)")
    ph.check("Dirichlet values held", abs(runs[False][0] - 1.0)
             + abs(runs[False][-1]), 0.0, "the hook sets them exactly")

    model64 = triflow.Model(BURGERS, "U", "nu", double=True)
    fs = burgers_fields(model64, N_small)
    f_gpu, _, _ = run_simulation(model64, fs, pars, dt, n, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        model_cpu = triflow.Model(BURGERS, "U", "nu", double=True)
        f_cpu, _, _ = run_simulation(model_cpu,
                                     burgers_fields(model_cpu, N_small),
                                     pars, dt, n, **kw)
    ph.check("N=1e4 card f64 vs CPU f64",
             np.max(np.abs(np.asarray(f_gpu["U"]) - np.asarray(f_cpu["U"]))),
             16 * n * EPS64 * kappa,
             "16 x steps x eps64 x kappa: same algorithm, other summation "
             "order (kernel sweeps vs scan sweeps)")
    ph.info.update(N=N, N_small=N_small, dt=dt, steps=n, kappa_inf=kappa)
    ph.done()


def phase_ensemble(card, B=1024, N=100_000, dt=0.05, n=2):
    """Phase 4: BASELINE config 5, B members x N, f32 RODASPR fixed steps;
    three members against single-grid runs on the card.  B is halved while
    the card runs out of memory (each cut is listed)."""
    import jax

    ph = Phase("ensemble-rodaspr-f32", card)
    model = triflow.Model(KS, "U", double=False)
    x = np.arange(N, dtype=np.float64) * DX
    cuts = []
    while True:
        rng = np.random.RandomState(4)
        phases = rng.rand(B, 1) * 2 * np.pi
        u0 = (np.cos(2 * np.pi * np.arange(N)[None] / N * 10 + phases)
              + 0.1 * rng.randn(B, N)).astype(np.float32)
        try:
            ens = Ensemble(model, u0, dict(periodic=True), x,
                           scheme=schemes.RODASPR, time_stepping=False,
                           tol=None)
            t0 = time.perf_counter()
            ens.step(dt)
            jax.block_until_ready(ens.u)
            ph.setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(n - 1):
                ens.step(dt)
            jax.block_until_ready(ens.u)
            ph.run_s = time.perf_counter() - t0
            break
        except jax.errors.JaxRuntimeError as err:
            if "RESOURCE_EXHAUSTED" not in str(err) or B == 1:
                raise
            cuts.append(dict(B=B, peak_bytes=jax.devices()[0].memory_stats()
                             .get("peak_bytes_in_use")))
            B //= 2
    u_ens = np.asarray(ens.u, np.float64)
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None)
    oracle = triflow.Model(KS, "U", compiler="numpy")
    J0 = oracle.backend.J_bands_impl(u0[:1].astype(np.float64),
                                     np.zeros((0, N)), np.zeros((0, N)), x,
                                     periodic=True)
    kappa, _ = kappa_inf(system_csc(J0, -GAMMA * dt, True))
    for m in (0, B // 2, B - 1):
        fields = model.fields_template(x=x, U=u0[m])
        t = 0.0
        for _ in range(n):
            t, fields = scheme(t, fields, dt, dict(periodic=True))
        ph.check(f"member {m} vs single-grid run",
                 np.max(np.abs(u_ens[m, 0] - np.asarray(fields["U"]))),
                 n * (RODASPR_STAGES + 1) * EPS32 * kappa
                 * np.max(np.abs(u0[m])),
                 f"steps x (stages+1) x eps32 x kappa (={kappa:.4g}) x "
                 "max|U0|: vmapped vs unbatched summation order")
    ph.info.update(B=B, N=N, dt=dt, steps=n, cells=B * N,
                   memory_cuts=cuts)
    ph.done()


def phase_df64(card, N=10_000, dt=0.0625, n=4):
    """Phase 5: precision mode ``double="df64"`` (plain XLA on the GPU)
    against CPU float64."""
    import jax

    ph = Phase("ks-df64", card)
    pars = dict(periodic=True)
    kw = dict(scheme=schemes.RODASPR, time_stepping=False, tol=None)
    model = triflow.Model(KS, "U", double="df64")
    f, ph.setup_s, ph.run_s = run_simulation(model, ks_fields(model, N),
                                             pars, dt, n, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        m64 = triflow.Model(KS, "U", double=True)
        f_cpu, _, _ = run_simulation(m64, ks_fields(m64, N), pars, dt, n,
                                     **kw)
        u64 = np.asarray(f_cpu["U"])
        J = m64.backend.J_bands(*device_arrays(m64, ks_fields(m64, N), pars),
                                periodic=True)
    kappa, _ = kappa_inf(system_csc(J, -GAMMA * dt, True))
    U0 = np.asarray(ks_fields(m64, N)["U"])
    ph.check("df64 trajectory vs CPU float64",
             np.max(np.abs(np.asarray(f["U"], np.float64) - u64)),
             n * (RODASPR_STAGES + 1) * EPS_DF64 * kappa
             * np.max(np.abs(U0)),
             "steps x (stages+1) x 2^-48 (df64 significand) x kappa "
             f"(={kappa:.4g}) x max|U0|")
    ph.info.update(N=N, dt=dt, steps=n)
    ph.done()


def triton_calls(lowered):
    """Triton kernel calls in a lowered program."""
    return lowered.as_text().count("__gpu$xla.gpu.triton")


def ks_step_runners(N, double, steps):
    """Jitted scans of ``steps`` fixed KS RODASPR steps, one with the sweep
    kernels and one traced with the lax.scan sweeps, plus their input."""
    import jax
    import jax.numpy as jnp
    from triflow_jax.ops import banded

    model = triflow.Model(KS, "U", double=double)
    scheme = schemes.RODASPR(model, time_stepping=False, tol=None)
    u, h, p, x = device_arrays(model, ks_fields(model, N), dict(periodic=True))
    fixed = scheme.device_fixed_step(periodic=True)
    dt = jnp.asarray(0.05, model.backend.dtype)

    def make_run():
        # a fresh function per version: JAX caches traces per function
        def run(u):
            def chain(u, _):
                return fixed(0.0, u, h, p, x, dt)[0], ()
            return jax.lax.scan(chain, u, length=steps)[0]
        return run

    kernel = jax.jit(make_run()).lower(u)
    with banded.scan_sweeps():
        scan = jax.jit(make_run()).lower(u)
    counts = {k: triton_calls(low) for k, low in
              (("kernel", kernel), ("scan", scan))}
    if not counts["kernel"] or counts["scan"]:
        raise SystemExit(f"sweep versions not as traced: {counts}")
    return {"kernel": kernel.compile(), "scan": scan.compile()}, u, counts


def phase_kernel(card, sizes=((1_000_000, 10), (10_000, 100))):
    """Phase 6: the sweep kernels against the lax.scan sweeps and scipy,
    and the RODASPR step time with and without them (the two versions
    alternate: kernel, scan, scan, kernel)."""
    import jax
    import jax.numpy as jnp
    from triflow_jax.ops import banded

    timings = []
    for N, steps in sizes:
        for double in (False, True):
            t0 = time.perf_counter()
            runners, u, counts = ks_step_runners(N, double, steps)
            setup = time.perf_counter() - t0
            best = {}
            for key in ("kernel", "scan", "scan", "kernel", "kernel", "scan"):
                out, sec = timed(runners[key], u)
                if not bool(jnp.isfinite(out).all()):
                    raise SystemExit(f"non-finite state ({key} sweeps)")
                best[key] = min(best.get(key, np.inf), sec / steps)
            timings.append(dict(
                N=N, dtype="float64" if double else "float32",
                kernel_step_s=best["kernel"], scan_step_s=best["scan"],
                compile_both_s=setup, triton_calls=counts,
                speedup=best["scan"] / best["kernel"]))
    print(json.dumps(dict(phase="kernel-step-timing", card=card,
                          rodaspr_steps=timings)), flush=True)

    ph = Phase("kernel-check", card)
    dt = 0.05
    beta = -GAMMA * dt
    for N, _steps in sizes:
        oracle = triflow.Model(KS, "U", compiler="numpy")
        f0 = ks_fields(oracle, N)
        for double in (False, True):
            eps = EPS64 if double else EPS32
            model = triflow.Model(KS, "U", double=double)
            u, h, p, x = device_arrays(model, f0, dict(periodic=True))
            J = model.backend.J_bands(u, h, p, x, periodic=True)
            b = jax.numpy.asarray(np.random.RandomState(2).randn(1, N),
                                  model.backend.dtype)

            def make_solve():
                # a fresh function per version: JAX caches traces per
                # function object
                return lambda J, b: banded.factor_linearized(
                    1.0, beta, J, True).solve(b)

            low_k = jax.jit(make_solve()).lower(J, b)
            with banded.scan_sweeps():
                low_s = jax.jit(make_solve()).lower(J, b)
            ph.check(f"N={N} {'f64' if double else 'f32'} Triton calls: "
                     "kernel version has some, scan version none",
                     0.0 if triton_calls(low_k) and not triton_calls(low_s)
                     else 1.0, 0.0, "the comparison must compare two "
                     "different programs")
            t0 = time.perf_counter()
            xk, _ = timed(low_k.compile(), J, b)
            ph.setup_s += time.perf_counter() - t0
            xs, _ = timed(low_s.compile(), J, b)
            kappa, lu = kappa_inf(system_csc(J, beta, True))
            xref = lu.solve(np.asarray(b, np.float64).T.flatten(),
                            trans="T")
            tag = f"N={N} {'f64' if double else 'f32'}"
            reason = (f"16 eps x kappa_inf (={kappa:.4g}), relative to "
                      "max|x|")
            ph.check(f"{tag} kernel vs lax.scan sweeps", rel_err(xk, xs),
                     16 * eps * kappa, reason)
            ph.check(f"{tag} kernel vs scipy", rel_err(
                np.asarray(xk).T.flatten(), xref), 16 * eps * kappa, reason)
            ph.check(f"{tag} lax.scan vs scipy", rel_err(
                np.asarray(xs).T.flatten(), xref), 16 * eps * kappa, reason)
    ph.done()


def phase_four(card, N=2 ** 22, B=64, Ne=100_000):
    """--four: the sharded KS grid over a 4-card "space" mesh and a
    64-member ensemble over a 4-card "ensemble" mesh, each against the same
    run on one card."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
    ph = Phase("four-card", card)
    dt, n = 0.05, 3
    model = triflow.Model(KS, "U", double=False)
    pars = dict(periodic=True)
    kw = dict(scheme=schemes.RODASPR, time_stepping=False, tol=None)
    fields = ks_fields(model, N)
    f1, _, r1 = run_simulation(model, fields, pars, dt, n, **kw)
    f4, ph.setup_s, ph.run_s = run_simulation(
        model, fields, pars, dt, n, mesh=Mesh(np.array(devices), ("space",)),
        **kw)
    U0 = np.asarray(fields["U"], np.float64)
    oracle = triflow.Model(KS, "U", compiler="numpy")
    J0 = oracle.backend.J_bands_impl(U0[None], np.zeros((0, N)),
                                     np.zeros((0, N)), np.asarray(fields["x"]),
                                     periodic=True)
    kappa, _ = kappa_inf(system_csc(J0, -GAMMA * dt, True))
    tol = n * (RODASPR_STAGES + 1) * EPS32 * kappa * np.max(np.abs(U0)) \
        * np.exp(0.25 * n * dt)
    why = (f"steps x (stages+1) x eps32 x kappa (={kappa:.4g}) x max|U0| x "
           "exp(t/4): distributed SPIKE vs single-card chunked solve")
    ph.check("space-sharded KS N=2^22 vs one card",
             np.max(np.abs(np.asarray(f4["U"], np.float64)
                           - np.asarray(f1["U"], np.float64))), tol, why)

    x = np.arange(Ne, dtype=np.float64) * DX
    rng = np.random.RandomState(5)
    u0 = (np.cos(2 * np.pi * np.arange(Ne)[None] / Ne * 10
                 + rng.rand(B, 1) * 2 * np.pi)
          + 0.1 * rng.randn(B, Ne)).astype(np.float32)
    outs = {}
    for mesh in (None, Mesh(np.array(devices), ("ensemble",))):
        ens = Ensemble(model, u0, dict(periodic=True), x,
                       scheme=schemes.RODASPR, time_stepping=False, tol=None,
                       mesh=mesh, mesh_axis="ensemble")
        for _ in range(2):
            ens.step(dt)
        outs[mesh is None] = np.asarray(ens.u, np.float64)
        if mesh is not None:
            ph.info["ensemble_devices"] = len(ens.u.sharding.device_set)
    ph.check("ensemble 64 x 1e5 over 4 cards vs one card",
             np.max(np.abs(outs[True] - outs[False])),
             2 * (RODASPR_STAGES + 1) * EPS32 * kappa * np.max(np.abs(u0)),
             "steps x (stages+1) x eps32 x kappa x max|U0|: members never "
             "communicate, only the placement differs")
    ph.info.update(N=N, dt=dt, steps=n, single_card_run_s=r1,
                   ensemble=dict(B=B, N=Ne))
    ph.done()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run the four-card paths and nothing else")
    args = parser.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from triflow_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    if args.four:
        phase_four(card)
        count = 4
    else:
        phase_ks(card)
        phase_burgers(card)
        phase_ensemble(card)
        phase_df64(card)
        phase_kernel(card)
        count = 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
