"""Temporal schemes: implicit/stiff integrators stepping the discretized
system on-device.

Scheme surface parity with upstream triflow/core/schemes.py:
callable objects ``scheme(t, fields, dt, pars, hook) -> (t, fields)``;
classes ``ROS2``, ``ROS3PRw``, ``ROS3PRL``, ``RODASPR`` (Rosenbrock-Wanner
family, coefficients from Rang 2013, http://www.digibib.tu-bs.de/?docid=00055262
— same tables the reference cites at schemes.py:69-74), ``Theta``
(backward/forward Euler, Crank-Nicolson), ``scipy_ode`` proxy, and the
universal ``time_stepping`` step-doubling wrapper (schemes.py:33-66).

Differences from the reference:

* one **device-resident step**: hook -> banded J -> BCR factorization ->
  stage solves all trace into a single jitted function; the adaptive-dt retry
  loop is a ``lax.while_loop`` carrying (t, state, dt, status), so an output
  step costs one host->device round trip regardless of how many internal
  steps it takes (the reference crosses into SuperLU per stage,
  schemes.py:148-163);
* failures can't raise inside jit: the loop carries a **status code**
  (0 ok, 1 max_iter exceeded, 2 dt < dt_min) checked on the host, which then
  raises the same RuntimeErrors as the reference (schemes.py:229-238);
* hooks are **pure traced functions** ``(t, fields, pars) -> (fields, pars)``
  operating on the Fields pytree (Dirichlet = functional scatter), not
  in-place numpy mutation;
* the embedded error is the mathematically intended ``||sum((b - b_hat) k)||``
  — the reference computes ``||sum(b_hat k)||`` because it adds the predictor
  increment to the *already updated* state (schemes.py:164-171); we implement
  the intent (SURVEY.md §2, "rebuild should implement the intent, not the
  bug").
"""

from __future__ import annotations

import logging
import weakref

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.banded import axpy_bands, banded_matvec, factor_linearized

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def null_hook(t, fields, pars):
    return fields, pars


def _seed_internal_dt(scheme, dt):
    """First-call internal dt for an adaptive scheme: small (1e-6) so the
    controller ramps up safely from an unknown state, but never below the
    user's dt_min — the 10x-per-accept growth cap cannot escape a seed
    under the floor, so a smaller seed would trip the dt-floor status code
    on a perfectly healthy problem."""
    if not getattr(scheme, "_time_control", False):
        return dt
    if getattr(scheme, "_seed_with_dt", False):
        # Richardson wrapper semantics (reference schemes.py:33-66): the
        # first coarse attempt IS the output dt; seeding smaller makes
        # chunked runs diverge from the stepwise __call__ path
        return dt
    dt_min = getattr(scheme, "_dt_min", None)
    seed = 1e-6
    if dt_min is not None:
        seed = max(seed, dt_min)
    return min(seed, dt)


# ---------------------------------------------------------------------------
# device-state plumbing shared by all schemes
# ---------------------------------------------------------------------------

def _tree_where(pred, a, b):
    """``jnp.where`` over matching pytrees (covers DF double-float state)."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b
    )


def _zeros_like_tree(u):
    return jax.tree_util.tree_map(jnp.zeros_like, u)


class _DeviceProblem:
    """Binds a model + hook + static periodic flag into pure array functions.

    State tuple: (u (nvar, N), helpers (nhelp, N), pstack (npar, N), x (N,)).

    With ``df64=True`` every state array is a DF double-float pair
    (ops/df64.py) and F/J evaluate through the backend's df64 twins —
    the reference's native-f64 compute path (model.py:148) at f32 speed.
    """

    def __init__(self, model, hook, periodic: bool, df64: bool = False):
        self.backend = model.backend
        self.system = model.backend.system
        self.template = model.fields_template
        self.hook = hook
        self.periodic = periodic
        self.df64 = df64

    def apply_hook(self, t, u, helpers, pstack, x):
        if self.hook is null_hook:
            return u, helpers, pstack, x
        if self.df64:
            return self._apply_hook_df64(t, u, helpers, pstack, x)
        sysm = self.system
        data = {"x": x}
        for i, name in enumerate(sysm.dep_vars):
            data[name] = u[i]
        for i, name in enumerate(sysm.help_funcs):
            data[name] = helpers[i]
        fields = self.template(**data)
        pars = {name: pstack[i] for i, name in enumerate(sysm.pars)}
        pars["periodic"] = self.periodic
        fields, pars = self.hook(t, fields, pars)
        u2 = jnp.stack([jnp.asarray(fields[n]) for n in sysm.dep_vars])
        if sysm.help_funcs:
            helpers2 = jnp.stack([jnp.asarray(fields[n]) for n in sysm.help_funcs])
        else:
            helpers2 = helpers
        x2 = jnp.asarray(fields["x"])
        N = x2.shape[-1]
        if sysm.pars:
            pstack2 = jnp.stack(
                [
                    jnp.broadcast_to(
                        jnp.asarray(pars[n], dtype=pstack.dtype), (N,)
                    )
                    for n in sysm.pars
                ]
            )
        else:
            pstack2 = pstack
        return u2, helpers2, pstack2, x2

    def _apply_hook_df64(self, t, u, helpers, pstack, x):
        """Hook semantics on double-float state: the hook sees the hi
        component (the f32 value); entries it ENFORCES get their lo zeroed
        (a Dirichlet scatter sets the exact new value), entries it leaves
        alone keep their full df64 pair.

        Enforcement detection is exact for state-independent targets
        (reference bar: hooks mutate f64 state exactly,
        upstream triflow/core/schemes.py:139-145).  Two hook
        evaluations run: one on the true hi state and one on a perturbed
        copy.  An entry whose output CHANGED vs the input is enforced; an
        entry whose output did NOT follow the input perturbation is also
        enforced (a Dirichlet constant re-imposing a value whose hi is
        already at the target — e.g. after the solver drifted only the lo
        component — is caught here, closing the ~ulp(hi)/2 ~ 6e-8 boundary
        hole of the changed-only rule).  Both classes get lo zeroed, so
        the enforced value is bit-exact.

        Remaining caveat (documented): a hook that COMPUTES its boundary
        value from the state (e.g. a mirror u[0] = u[1]) moves with the
        perturbation, so it is only caught by the changed-vs-input rule —
        if its hi already equals the target while lo drifted, enforcement
        is f32-granular for that entry.  Dirichlet/parameter/x-derived
        targets — every reference-style hook — are state-independent and
        therefore exact."""
        from ..ops.df64 import DF

        u2h, h2h, p2, x2h = self._plain_hook(
            t, u.hi, helpers.hi, pstack.hi, x.hi)
        # perturbed state probe: d >= max(|a|, 1) * 2^-10 always survives
        # f32 rounding, so every state entry is visibly moved
        delta = np.float32(2.0 ** -10)

        def perturb(a):
            return a + jnp.maximum(jnp.abs(a), 1.0) * delta

        u2p, h2p, _p2p, _x2p = self._plain_hook(
            t, perturb(u.hi), perturb(helpers.hi), pstack.hi, x.hi)
        enforced_u = (u2h != u.hi) | (u2h == u2p)
        u_new = DF.wrap(u2h, jnp.where(enforced_u, 0.0, u.lo))
        enforced_h = (h2h != helpers.hi) | (h2h == h2p)
        h_new = DF.wrap(h2h, jnp.where(enforced_h, 0.0, helpers.lo))
        # x / pstack are not perturbed (hook targets routinely DERIVE from
        # them, and they are inputs, not solver-evolved state): the
        # changed-only rule suffices there
        changed_x = x2h != x.hi
        x_new = DF.wrap(x2h, jnp.where(changed_x, 0.0, x.lo))
        changed_p = p2 != pstack.hi
        p_new = DF.wrap(p2, jnp.where(changed_p, 0.0, pstack.lo))
        return u_new, h_new, p_new, x_new

    def _plain_hook(self, t, u, helpers, pstack, x):
        """The f32 hook application (the non-df64 apply_hook body)."""
        saved, self.df64 = self.df64, False
        try:
            return self.apply_hook(t, u, helpers, pstack, x)
        finally:
            self.df64 = saved

    def F(self, u, helpers, pstack, x):
        if self.df64:
            return self.backend.F_df64(u, helpers, pstack, x,
                                       periodic=self.periodic)
        return self.backend.F_impl(u, helpers, pstack, x, periodic=self.periodic)

    def J_bands(self, u, helpers, pstack, x):
        if self.df64:
            return self.backend.J_bands_df64(u, helpers, pstack, x,
                                             periodic=self.periodic)
        return self.backend.J_bands_impl(u, helpers, pstack, x, periodic=self.periodic)

class _SchemeBase:
    """Host-facing callable-scheme machinery: splits Fields into device
    arrays, dispatches to a per-(hook, periodic) jitted stepper, rebuilds
    Fields."""

    def __init__(self, model):
        self._model = model
        self._steppers = {}
        self._compensated = False
        self._df64 = getattr(model, "precision", None) == "df64"

    # subclasses build the jitted stepper for a bound problem
    def _build_stepper(self, problem):
        raise NotImplementedError

    def _get_stepper(self, hook, periodic):
        key = (hook, periodic)
        if key not in self._steppers:
            problem = _DeviceProblem(self._model, hook, periodic,
                                     df64=self._df64)
            self._steppers[key] = self._build_stepper(problem)
        return self._steppers[key]

    def device_stepper(self, hook=null_hook, periodic=True):
        """Pure jitted stepper over raw device state — the building block for
        ensembles (vmap), sharded runs and benchmarks.

        Signature: ``step(t, u, helpers, pstack, x, dt, internal_dt) ->
        (t', u', helpers', pstack', x', internal_dt', niter, status)``.
        """
        return self._get_stepper(hook, periodic)

    def device_fixed_step(self, hook=null_hook, periodic=True):
        """Pure single fixed step (no adaptive loop) where the scheme defines
        one: ``fixed(t, u, helpers, pstack, x, dt) -> (u', helpers', pstack',
        x', err)``; ensembles vmap it over the member axis."""
        problem = _DeviceProblem(self._model, hook, periodic,
                                 df64=self._df64)
        return self._fixed_step_fn(problem)

    def device_steps(self, t, fields, n, dt, pars, hook=null_hook):
        """Advance ``n`` output steps of ``dt`` in ONE device call (a
        lax.scan over the stepper) and return ``(t_final, snapshots,
        status)`` where snapshots is a list of (t_i, fields_i), one per
        output step.  Every call pays a host sync; this is the
        amortization primitive behind ``Simulation.run(device_chunk=...)``
        (hooks run traced inside the step, exactly as in the adaptive
        inner loop).

        On failure (status != 0) only the snapshots of the steps completed
        BEFORE the first failing step are returned, so callers can persist
        the valid prefix before surfacing the error.

        Memory: the scan stacks all ``n`` (t, u, helpers) snapshots on the
        device — device memory scales as n x state size.  Callers bound n
        (Simulation._run_chunked caps the per-call snapshot bytes)."""
        periodic = bool(pars.get("periodic", False))
        stepper = self._get_stepper(hook, periodic)
        key = (hook, periodic, "scan")
        compensated = self._compensated
        if key not in self._steppers:
            from ..ops.compensated import kahan_update

            def scan_run(t, u, h, p, x, dt, internal_dt, n):
                def body(carry, _):
                    t_, u_, c_, h_, p_, x_, dti, status = carry
                    t2, u2, h2, p2, x2, dti2, _ni, st2 = stepper(
                        t_, u_, h_, p_, x_, dt, dti)
                    if compensated:
                        u2, c_ = kahan_update(u_, c_, u2)
                    st = jnp.maximum(status, st2)
                    return ((t2, u2, c_, h2, p2, x2, dti2, st),
                            (t2, u2, h2, st))
                carry = (t, u, _zeros_like_tree(u), h, p, x, internal_dt,
                         jnp.int32(0))
                return jax.lax.scan(body, carry, length=n)
            self._steppers[key] = jax.jit(scan_run, static_argnums=(7,))
        u, helpers, pstack, x = self._split(fields, pars)
        internal_dt = getattr(self, "_internal_dt", None)
        if internal_dt is None:
            internal_dt = _seed_internal_dt(self, dt)
        carry, (ts, us, hs, sts) = self._steppers[key](
            jnp.asarray(t, u.dtype), u, helpers, pstack, x,
            jnp.asarray(dt, u.dtype), jnp.asarray(internal_dt, u.dtype),
            int(n))
        _t2, _u2, _c2, _h2, _p2, x2, dt_i, _status = carry
        if hasattr(self, "_internal_dt"):
            # keep the adapted dt device-resident: it is fed straight back
            # into the next chunk's scan, and a float() here is a host
            # sync per call
            self._internal_dt = dt_i
        # ONE bulk transfer per stacked output instead of a scalar sync for
        # t/status plus one array fetch per snapshot downstream
        from ..ops.df64 import DF

        ts = np.asarray(ts)
        sts = np.asarray(sts)
        us = us.to_float64() if isinstance(us, DF) else np.asarray(us)
        hs = hs.to_float64() if isinstance(hs, DF) else np.asarray(hs)
        if isinstance(x2, DF):
            x2 = x2.to_float64()
        status = int(sts[-1]) if int(n) else 0
        n_valid = int(n) if status == 0 else int(np.argmax(sts != 0))
        snapshots = [
            (float(ts[i]), self._rebuild(fields, us[i], hs[i], x2))
            for i in range(n_valid)
        ]
        t_final = float(ts[-1]) if int(n) else float(t)
        return t_final, snapshots, status

    def _fixed_step_fn(self, problem):
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a single fixed step"
        )

    def _split(self, fields, pars):
        backend = self._model.backend
        if self._df64:
            return self._split_df64(fields, pars)
        u, helpers, x = backend.split_fields(fields)
        pstack = backend.pack_pars(pars, x)
        return u, helpers, pstack, x

    def _split_df64(self, fields, pars):
        """Host f64 fields -> DF double-float device state (exact split)."""
        from ..ops.df64 import DF

        sysm = self._model.backend.system
        N = fields.size
        x = np.asarray(fields["x"], dtype=np.float64)
        if sysm.dep_vars:
            u = np.stack([np.asarray(fields[k], dtype=np.float64)
                          for k in sysm.dep_vars])
        else:
            u = np.zeros((0, N))
        if sysm.help_funcs:
            helpers = np.stack([np.asarray(fields[k], dtype=np.float64)
                                for k in sysm.help_funcs])
        else:
            helpers = np.zeros((0, N))
        rows = [np.broadcast_to(np.asarray(pars[key], dtype=np.float64), (N,))
                for key in sysm.pars]
        pstack = np.stack(rows) if rows else np.zeros((0, N))
        return (DF.from_float64(u), DF.from_float64(helpers),
                DF.from_float64(pstack), DF.from_float64(x))

    def _rebuild(self, fields, u, helpers, x):
        from ..ops.df64 import DF

        if isinstance(u, DF):
            u = u.to_float64()
            helpers = (helpers.to_float64() if isinstance(helpers, DF)
                       else helpers)
            x = x.to_float64() if isinstance(x, DF) else np.asarray(x)
            if jax.config.jax_enable_x64:
                # keep jax-array semantics for host-side hooks (.at[...])
                # wherever f64 device arrays exist; without x64 the host
                # state stays numpy f64 and hooks apply traced in-device
                # (Simulation skips the host re-application)
                u, helpers, x = (jnp.asarray(u), jnp.asarray(helpers),
                                 jnp.asarray(x))
        sysm = self._model.backend.system
        data = {"x": x}
        for i, name in enumerate(sysm.dep_vars):
            data[name] = u[i]
        for i, name in enumerate(sysm.help_funcs):
            data[name] = helpers[i]
        return self._model.fields_template(**data)


# ---------------------------------------------------------------------------
# Rosenbrock-Wanner family
# ---------------------------------------------------------------------------

def _df64_mixed_solver(J, coef_df, coef32, mixed, periodic):
    """``solve(rhs_df)`` for the df64 system ``(I - coef*J) k = rhs`` via
    an f32 preconditioner + ``mixed`` df64-residual refinement passes
    (Higham-style; the scheme proven at the full-df64 accuracy class in
    tests/test_precision.py).  Shared by the ROW stage solves and the
    theta step.

    The preconditioner factors the ROUNDED system ``I - coef32*J32``.
    ``coef_df`` is the full double-float coefficient (used for the
    residual), ``coef32`` its f32 value (used for the factorization).
    Residuals come straight from the df64 J bands — no materialized
    A = I - coef*J pair array."""
    from ..ops.banded_df import banded_matvec_df
    from ..ops.df64 import DF

    fact32 = factor_linearized(1.0, -coef32, J.hi + J.lo, periodic)

    def solve(rhs_df):
        k = DF(fact32.solve(rhs_df.hi + rhs_df.lo))
        for _ in range(mixed):
            jk = banded_matvec_df(J, k, periodic)
            r = (rhs_df - k) + coef_df * jk
            k = k + DF(fact32.solve(r.hi + r.lo))
        return k

    return solve


def _adaptive_embedded_loop(fixed_step, *, tol, safety, max_iter, dt_min,
                            compensated, exponent=0.5, interpolate=False,
                            precise_time=False):
    """Generic embedded-error adaptive retry loop over a fixed step.

    ``fixed_step(t, u, helpers, pstack, x, dt) -> (u', h', p', x', err)``
    supplies the attempt and its embedded error estimate; the returned
    ``loop(t, u, helpers, pstack, x, dt, internal_dt) -> (next_t, u', h',
    p', x', dt_i, niter, status)`` advances from ``t`` to ``t + dt`` in a
    single ``lax.while_loop`` carrying (t, state, dt, status) — one device
    dispatch per output step no matter how many internal attempts run.
    The caller applies the output-time hook.

    ``exponent`` is the controller exponent in
    ``dt <- safety * dt * (tol/err)**exponent``: 1/2 reproduces the
    reference's ROW controller (schemes.py:203-204); an embedded RK pair
    whose lower order is q wants 1/(q+1).

    ``interpolate=True`` is the reference's ``recompute_target=False``
    semantics (schemes.py:213-227): internal steps never clamp to the
    output time — the loop overshoots and the state at ``t + dt`` is
    linearly interpolated between the bracketing internal steps, so the
    adapted dt is undisturbed by the output grid (O(dt_i^2) interpolation
    error, the documented tradeoff).

    ``precise_time=True`` (the df64 path) carries the internal clock as a
    compensated (hi, lo) f32 pair: the plain f32 accumulation quantizes
    each accepted step by ~ulp(t)/2, which puts an irreducible ~1e-7
    time-grid error on the trajectory — far above the df64 state's
    ~1e-13.  The host clock is f64 either way; only the within-output-step
    accumulation needs the pair."""

    def unpack(carry):
        # the bracketing (tp, up) pre-step snapshot rides in the carry ONLY
        # in interpolate mode — in the default mode it would be a dead full
        # state copy written back every while iteration
        if interpolate:
            return carry
        t_, u_, cu, h, p, x_, dt_i, niter, status = carry
        return (t_, None, None, u_, cu, h, p, x_, dt_i, niter, status)

    def pack(t_, tp, up, u_, cu, h, p, x_, dt_i, niter, status):
        if interpolate:
            return (t_, tp, up, u_, cu, h, p, x_, dt_i, niter, status)
        return (t_, u_, cu, h, p, x_, dt_i, niter, status)

    # internal-clock representation: scalar f32, or a compensated
    # (hi, lo) pair under precise_time
    if precise_time:
        def t_make(t):
            return (t, jnp.zeros_like(t))

        def t_rem(t_, next_t):
            return (next_t - t_[0]) - t_[1]

        def t_adv(t_, dt_eff, accept):
            from ..ops.df64 import add_f

            th2, tl2 = add_f(t_[0], t_[1], dt_eff)
            return (jnp.where(accept, th2, t_[0]),
                    jnp.where(accept, tl2, t_[1]))

        def t_val(t_):
            return t_[0] + t_[1]
    else:
        def t_make(t):
            return t

        def t_rem(t_, next_t):
            return next_t - t_

        def t_adv(t_, dt_eff, accept):
            return jnp.where(accept, t_ + dt_eff, t_)

        def t_val(t_):
            return t_

    def loop(t, u, helpers, pstack, x, dt, internal_dt):
        next_t = t + dt
        eps = 1e-12 * jnp.maximum(jnp.abs(next_t), 1.0)

        def cond(carry):
            t_ = carry[0]
            status = carry[-1]
            return (t_rem(t_, next_t) > eps) & (status == 0)

        def body(carry):
            t_, tp, up, u_, cu, h, p, x_, dt_i, niter, status = unpack(carry)
            if interpolate:
                clamped = jnp.full((), False)
                dt_eff = dt_i
            else:
                remaining = t_rem(t_, next_t)
                clamped = dt_i >= remaining
                dt_eff = jnp.minimum(dt_i, remaining)
            u2, h2, p2, x2, err = fixed_step(t_val(t_), u_, h, p, x_, dt_eff)
            accept = err <= tol
            if interpolate:
                # remember the bracketing pre-step state for the final
                # interpolation to next_t
                tp = jnp.where(accept, t_val(t_), tp)
                up = _tree_where(accept, u_, up)
            # controller: dt <- safety * dt * (tol / err)**exponent
            # (reference schemes.py:203-204), with growth capped at 10x
            # per step (the reference's uncapped controller can jump to
            # inf when err underflows); when the step was clamped to hit
            # the target and accepted, keep the pre-clamp dt so the next
            # output step doesn't lose the adapted step size
            err_safe = jnp.maximum(err, jnp.finfo(dt_eff.dtype).tiny)
            if exponent == 0.5:
                dt_next = safety * dt_eff * jnp.sqrt(tol / err_safe)
            else:
                dt_next = safety * dt_eff * (tol / err_safe) ** exponent
            # clamp growth AND shrink (10x / 0.1x per attempt): an
            # inf/NaN stage must retry at a smaller dt, not jump to zero
            dt_next = jnp.clip(dt_next, 0.1 * dt_eff, 10.0 * dt_eff)
            dt_i_new = jnp.where(accept & clamped, dt_i, dt_next)
            t_ = t_adv(t_, dt_eff, accept)
            if compensated:
                from ..ops.compensated import kahan_update

                uk, ck = kahan_update(u_, cu, u2)
                u_ = jnp.where(accept, uk, u_)
                cu = jnp.where(accept, ck, cu)
            else:
                u_ = jax.tree_util.tree_map(
                    lambda a, bnew: jnp.where(accept, bnew, a), u_, u2
                )
            h = jax.tree_util.tree_map(
                lambda a, bnew: jnp.where(accept, bnew, a), h, h2
            )
            p = jax.tree_util.tree_map(
                lambda a, bnew: jnp.where(accept, bnew, a), p, p2
            )
            niter = niter + jnp.int32(1)
            if max_iter is not None:
                status = jnp.where(niter > jnp.int32(max_iter),
                                   jnp.int32(1), status)
            # dt floor: the user's dt_min if given, else the roundoff
            # no-progress threshold (t + dt == t) so a diverging problem
            # (err -> inf, dt -> 0) raises instead of spinning the
            # while_loop forever
            dt_floor = dt_min if dt_min is not None else (
                1e3 * jnp.finfo(dt_eff.dtype).tiny
                + 2.0 * jnp.finfo(dt_eff.dtype).eps * jnp.abs(next_t)
            )
            status = jnp.where(dt_i_new < dt_floor, jnp.int32(2), status)
            return pack(t_, tp, up, u_, cu, h, p, x_, dt_i_new, niter,
                        status)

        # in interpolate mode the whole point is that the internal dt is
        # NOT disturbed by the output cadence — never clamp it to dt
        dt0 = internal_dt if interpolate else jnp.minimum(internal_dt, dt)
        carry = pack(t_make(t), t, u, u, _zeros_like_tree(u), helpers,
                     pstack, x, dt0, jnp.int32(0), jnp.int32(0))
        import os as _os

        chunk = int(_os.environ.get("TRIFLOW_ADAPT_SCAN", 0))
        if chunk > 1:
            # experimental: run the retry loop as a while_loop of CHUNK-length scans with no-op
            # masking after completion — scan iterations pipeline where
            # while_loop iterations serialize, at the cost of <= CHUNK-1
            # masked wasted attempts per output step.  Decisions are
            # identical, so the trajectory is bit-equal to the plain loop.
            def body_scan(c, _):
                live = (t_rem(c[0], next_t) > eps) & (c[-1] == 0)
                new = body(c)
                c = jax.tree_util.tree_map(
                    lambda o, nw: jnp.where(live, nw, o), c, new)
                return c, ()

            def body_chunk(c):
                return jax.lax.scan(body_scan, c, length=chunk)[0]

            final = jax.lax.while_loop(cond, body_chunk, carry)
        else:
            final = jax.lax.while_loop(cond, body, carry)
        (t2, tp, up, u2, _cu, h2, p2, x2, dt_i, niter,
         status) = unpack(final)
        t2 = t_val(t2)
        if interpolate:
            # state at next_t from the bracketing internal steps
            # (reference schemes.py:213-227); t2 >= next_t on a clean exit
            span = jnp.maximum(t2 - tp, jnp.finfo(x.dtype).tiny)
            w = jnp.clip((next_t - tp) / span, 0.0, 1.0)
            u2 = up + w * (u2 - up)
        return next_t, u2, h2, p2, x2, dt_i, niter, status

    return loop


class ROW_general(_SchemeBase):
    """Generic s-stage Rosenbrock-Wanner solver with one banded factorization
    per step reused across all stages, embedded-order error estimate and an
    adaptive-dt controller running in ``lax.while_loop``
    (reference: schemes.py:69-238)."""

    def __init__(self, model, alpha, gamma, b, b_pred=None,
                 time_stepping=False, tol=None, max_iter=None, dt_min=None,
                 safety_factor=0.9, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        super().__init__(model)
        # df64 state already carries ~49-bit significands; the f32 Kahan
        # track would be both redundant and DF-incompatible
        self._compensated = compensated and not self._df64
        self._refine = int(refine)
        # df64 models only: n > 0 replaces the full-df64 stage solves with
        # mixed-precision iterative refinement — an f32 factorization of
        # the ROUNDED system preconditions n
        # df64-residual correction passes against the df64 operator
        # (Higham-style).  Error per solve ~ (eps32 * cond)^n vs the
        # ~1e-14 of the full-df64 solver; n=2 meets the 1e-8 target at a
        # fraction of the cost (no df64 factorization, no df64 sweeps).
        # Default (None -> 0, the full-df64 solver): mixed is the
        # recommended THROUGHPUT config (measured at the same ~1e-13
        # accuracy class on every BASELINE workload at >10x the rate),
        # but its per-solve residue ~(eps32*cond)^n pollutes the embedded
        # ERROR ESTIMATE: at tight tolerances (tol <~ 1e-8) on stiff
        # systems the controller sees solve noise instead of truncation
        # error and grinds at tiny dt (measured: 33k internal iterations
        # on a tol=1e-8 Dirichlet heat run that the full solver does in a
        # handful).  The full solver stays the default exactly like the
        # reference's unconditional f64; opt into mixed explicitly.
        self._df64_mixed = ((0 if df64_mixed_solve is None
                             else int(df64_mixed_solve))
                            if self._df64 else 0)
        self._alpha = np.asarray(alpha, dtype=np.float64)
        self._gamma = np.asarray(gamma, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        self._b_pred = None if b_pred is None else np.asarray(b_pred, np.float64)
        self._s = len(b)
        # Hairer-Wanner transformed tables (Solving ODEs II, ch. IV.7): with
        # u_tilde_i = sum_{j<=i} gamma_ij k_j the stage equations become
        #   (I - g00*dt*J) ut_i = g00*dt*F(u + sum a_ij ut_j)
        #                          + g00 * sum_{j<i} c_ij ut_j
        # -- the per-stage banded matvec dt*J@(sum gamma_ij k_j) of the
        # reference formulation (schemes.py:152-163) disappears entirely;
        # only elementwise linear combinations remain.  Algebraically
        # identical to the untransformed step.
        s = self._s
        g00 = self._gamma[0, 0]
        G = np.tril(self._gamma, -1) + g00 * np.eye(s)
        Ginv = np.linalg.inv(G)
        self._a_t = self._alpha @ Ginv                  # strictly lower
        self._c_t = -np.tril(Ginv, -1)                  # strictly lower
        self._m_t = self._b @ Ginv
        self._m_pred_t = (None if b_pred is None
                          else np.asarray(b_pred, np.float64) @ Ginv)
        self._time_control = time_stepping
        self._tol = tol
        self._safety_factor = safety_factor
        self._max_iter = max_iter
        self._dt_min = dt_min
        self._err_exponent = 0.5  # reference ROW controller (schemes.py:203)
        self._recompute_target = recompute_target
        self._internal_dt = None
        self._internal_iter = None
        if time_stepping and b_pred is None:
            raise NotImplementedError(
                "time stepping requires the predictor (b_pred) coefficients"
            )
        if time_stepping and tol is None:
            raise ValueError("time_stepping=True requires a tolerance (tol)")

    # ---- traced pieces ----------------------------------------------------
    @property
    def _tables(self):
        return (self._a_t, self._c_t, self._m_t, self._m_pred_t,
                self._gamma[0, 0])

    def _fixed_step_fn(self, problem):
        tables = self._tables
        if self._tol is None and not self._time_control:
            # no controller will ever read the embedded error: drop the
            # predictor row so the final stage combination emits one output
            # instead of two (saves the diff write + its max-reduction read
            # per step; err comes back as inf)
            tables = tables[:3] + (None,) + tables[4:]
        a_t, c_t, m_t, m_pred_t, g00 = tables
        s = self._s
        periodic = problem.periodic
        refine = getattr(self, "_refine", 0)

        df64 = self._df64

        def fixed_step(t, u, helpers, pstack, x, dt):
            u, helpers, pstack, x = problem.apply_hook(t, u, helpers, pstack, x)
            J = problem.J_bands(u, helpers, pstack, x)
            if df64:
                from ..ops.banded_df import (axpy_bands_df,
                                             banded_matvec_df,
                                             factor_banded_df)
                from ..ops.df64 import DF, from_scalar

                # -g00*dt in full df64: the exact-double table constant
                # times the (exact) f32 dt
                g00_df = DF.wrap(*from_scalar(float(g00)))
                gdt = g00_df * DF(dt)
                mixed = getattr(self, "_df64_mixed", 0)
                if mixed:
                    # f32 preconditioner + df64-residual refinement (see
                    # _df64_mixed_solver)
                    mixed_solve = _df64_mixed_solver(
                        J, gdt, float(g00) * dt, mixed, periodic)

                    class _MixedFact:
                        def solve(self_, rhs_df):
                            return mixed_solve(rhs_df)

                    fact = _MixedFact()
                else:
                    fact = factor_banded_df(
                        axpy_bands_df(1.0, -gdt, J), periodic)
                mv = banded_matvec_df
            else:
                fact = factor_linearized(1.0, -float(g00) * dt, J, periodic)
                gdt = float(g00) * dt
                mv = banded_matvec
            # Hairer-Wanner transformed stages (see __init__): one banded
            # factorization, s solves, NO per-stage banded matvec
            us = []
            for i in range(s):
                u_i = u
                for j in range(i):
                    if a_t[i, j]:
                        u_i = u_i + float(a_t[i, j]) * us[j]
                F_i = problem.F(u_i, helpers, pstack, x)
                rhs = gdt * F_i
                for j in range(i):
                    if c_t[i, j]:
                        rhs = rhs + float(g00 * c_t[i, j]) * us[j]
                k_i = fact.solve(rhs)
                for _ in range(refine):
                    # one iterative-refinement pass per stage: recover the
                    # residual of (I - g00*dt*J) k = rhs against the TRUE
                    # banded operator and correct through the factorization
                    r = rhs - (k_i - gdt * mv(J, k_i, periodic))
                    k_i = k_i + fact.solve(r)
                us.append(k_i)
            u_new = u
            for i in range(s):
                u_new = u_new + float(m_t[i]) * us[i]
            if m_pred_t is not None:
                # intended embedded error: ||sum((b - b_hat) k)||_inf
                diff = None
                for i in range(s):
                    c = m_t[i] - m_pred_t[i]
                    if c:
                        diff = (float(c) * us[i] if diff is None
                            else diff + float(c) * us[i])
                if df64:
                    from ..ops.df64 import df_max_abs

                    err = df_max_abs(diff)
                else:
                    err = jnp.max(jnp.abs(diff))
                err = jnp.where(jnp.isnan(err) | jnp.isinf(err), jnp.inf, err)
            else:
                err = jnp.asarray(jnp.inf, dtype=jnp.float32 if df64
                                  else u.dtype)
            return u_new, helpers, pstack, x, err

        return fixed_step

    def _build_stepper(self, problem):
        fixed_step = self._fixed_step_fn(problem)

        if not self._time_control:
            def stepper(t, u, helpers, pstack, x, dt, internal_dt):
                u2, h2, p2, x2, _ = fixed_step(t, u, helpers, pstack, x, dt)
                # post-step hook (reference __call__: schemes.py:138-140)
                u2, h2, p2, x2 = problem.apply_hook(t + dt, u2, h2, p2, x2)
                return (t + dt, u2, h2, p2, x2, internal_dt,
                        jnp.int32(0), jnp.int32(0))
            return jax.jit(stepper)

        tol = self._tol
        safety = self._safety_factor
        max_iter = self._max_iter
        dt_min = self._dt_min
        compensated = self._compensated
        interp = not self._recompute_target
        generic_loop = _adaptive_embedded_loop(
            fixed_step, tol=tol, safety=safety, max_iter=max_iter,
            dt_min=dt_min, compensated=compensated, exponent=0.5,
            interpolate=interp, precise_time=self._df64)

        def stepper(t, u, helpers, pstack, x, dt, internal_dt):
            next_t = t + dt
            (_nt, u2, h2, p2, x2, dt_i, niter,
             status) = generic_loop(t, u, helpers, pstack, x, dt, internal_dt)
            # final hook at the output time (schemes.py:233-236)
            u2, h2, p2, x2 = problem.apply_hook(next_t, u2, h2, p2, x2)
            return next_t, u2, h2, p2, x2, dt_i, niter, status

        return jax.jit(stepper)

    # ---- host API -----------------------------------------------------------
    def __call__(self, t, fields, dt, pars, hook=null_hook):
        """Advance the system from t to t+dt (one output step; any number of
        adaptive internal steps happen on-device)."""
        periodic = bool(pars.get("periodic", False))
        stepper = self._get_stepper(hook, periodic)
        u, helpers, pstack, x = self._split(fields, pars)
        internal_dt = self._internal_dt
        if internal_dt is None:
            internal_dt = _seed_internal_dt(self, dt)
        t2, u2, h2, p2, x2, dt_i, niter, status = stepper(
            jnp.asarray(t, dtype=u.dtype), u, helpers, pstack, x,
            jnp.asarray(dt, dtype=u.dtype), jnp.asarray(internal_dt, u.dtype),
        )
        status = int(status)
        if status == 1:
            raise RuntimeError(
                "Rosenbrock internal iteration above max iterations authorized"
            )
        if status == 2:
            raise RuntimeError(
                "Rosenbrock internal time step less than authorized"
            )
        self._internal_dt = float(dt_i)
        self._internal_iter = int(niter)
        return float(t2), self._rebuild(fields, u2, h2, x2)


class ROS2(ROW_general):
    """2nd-order 2-stage Rosenbrock scheme, no time stepping
    (coefficients: reference schemes.py:241-256)."""

    def __init__(self, model, df64_mixed_solve=None):
        gamma = np.array([[2.928932188134e-1, 0],
                          [-5.857864376269e-1, 2.928932188134e-1]])
        alpha = np.array([[0, 0],
                          [1, 0]])
        b = np.array([1 / 2, 1 / 2])
        super().__init__(model, alpha, gamma, b, time_stepping=False,
                         df64_mixed_solve=df64_mixed_solve)


class ROS3PRw(ROW_general):
    """3rd-order W-method ROS3PRw with embedded error control
    (Rang 2013 table; reference schemes.py:259-300)."""

    def __init__(self, model, tol=1e-1, time_stepping=True,
                 max_iter=None, dt_min=None, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        alpha = np.zeros((3, 3))
        gamma = np.zeros((3, 3))
        gamma_i = 7.8867513459481287e-01
        b = [5.0544867840851759e-01,
             -1.1571687603637559e-01,
             6.1026819762785800e-01]
        b_pred = [2.8973180237214197e-01,
                  1.0000000000000001e-01,
                  6.1026819762785800e-01]
        alpha[1, 0] = 2.3660254037844388e+00
        alpha[2, 0] = 5.0000000000000000e-01
        alpha[2, 1] = 7.6794919243112270e-01
        gamma[0, 0] = gamma[1, 1] = gamma[2, 2] = gamma_i
        gamma[1, 0] = -2.3660254037844388e+00
        gamma[2, 0] = -8.6791218280355165e-01
        gamma[2, 1] = -8.7306695894642317e-01
        super().__init__(model, alpha, gamma, b, b_pred=b_pred,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         recompute_target=recompute_target,
                         compensated=compensated, refine=refine,
                         df64_mixed_solve=df64_mixed_solve)


class ROS3PRL(ROW_general):
    """4-stage stiffly-accurate ROS3PRL with embedded error control
    (Rang 2013 table; reference schemes.py:303-353)."""

    def __init__(self, model, tol=1e-1, time_stepping=True,
                 max_iter=None, dt_min=None, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        alpha = np.zeros((4, 4))
        gamma = np.zeros((4, 4))
        gamma_i = 4.3586652150845900e-01
        b = [2.1103008548132443e-03,
             8.8607515441580453e-01,
             -3.2405197677907682e-01,
             4.3586652150845900e-01]
        b_pred = [5.0000000000000000e-01,
                  3.8752422953298199e-01,
                  -2.0949226315045236e-01,
                  3.2196803361747034e-01]
        alpha[1, 0] = .5
        alpha[2, 0] = .5
        alpha[2, 1] = .5
        alpha[3, 0] = .5
        alpha[3, 1] = .5
        alpha[3, 2] = 0
        for i in range(len(b)):
            gamma[i, i] = gamma_i
        gamma[1, 0] = -5.0000000000000000e-01
        gamma[2, 0] = -7.9156480420464204e-01
        gamma[2, 1] = 3.5244216792751432e-01
        gamma[3, 0] = -4.9788969914518677e-01
        gamma[3, 1] = 3.8607515441580453e-01
        gamma[3, 2] = -3.2405197677907682e-01
        super().__init__(model, alpha, gamma, b, b_pred=b_pred,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         recompute_target=recompute_target,
                         compensated=compensated, refine=refine,
                         df64_mixed_solve=df64_mixed_solve)


class RODASPR(ROW_general):
    """6-stage RODASPR (order 4(3), the reference's default scheme;
    coefficients: Rang 2013 table; reference schemes.py:356-427)."""

    def __init__(self, model, tol=1e-1, time_stepping=True,
                 max_iter=None, dt_min=None, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        alpha = np.zeros((6, 6))
        gamma = np.zeros((6, 6))
        b = [-7.9683251690137014e-1,
             6.2136401428192344e-2,
             1.1198553514719862e0,
             4.7198362114404874e-1,
             -1.0714285714285714e-1,
             2.5e-1]
        b_pred = [-7.3844531665375115e0,
                  -3.0593419030174646e-1,
                  7.8622074209377981e0,
                  5.7817993590145966e-1,
                  2.5e-1,
                  0]
        alpha[1, 0] = 7.5e-1
        alpha[2, 0] = 7.5162877593868457e-2
        alpha[2, 1] = 2.4837122406131545e-2
        alpha[3, 0] = 1.6532708886396510e0
        alpha[3, 1] = 2.1545706385445562e-1
        alpha[3, 2] = -1.3157488872766792e0
        alpha[4, 0] = 1.9385003738039885e1
        alpha[4, 1] = 1.2007117225835324e0
        alpha[4, 2] = -1.9337924059522791e1
        alpha[4, 3] = -2.4779140110062559e-1
        alpha[5, 0] = -7.3844531665375115e0
        alpha[5, 1] = -3.0593419030174646e-1
        alpha[5, 2] = 7.8622074209377981e0
        alpha[5, 3] = 5.7817993590145966e-1
        alpha[5, 4] = 2.5e-1
        gamma_i = .25
        for i in range(len(b)):
            gamma[i, i] = gamma_i
        gamma[1, 0] = -7.5e-1
        gamma[2, 0] = -8.8644e-2
        gamma[2, 1] = -2.868897e-2
        gamma[3, 0] = -4.84700e0
        gamma[3, 1] = -3.1583e-1
        gamma[3, 2] = 4.9536568e0
        gamma[4, 0] = -2.67694569e1
        gamma[4, 1] = -1.5066459e0
        gamma[4, 2] = 2.720013e1
        gamma[4, 3] = 8.25971337e-1
        gamma[5, 0] = 6.58762e0
        gamma[5, 1] = 3.6807059e-1
        gamma[5, 2] = -6.74235e0
        gamma[5, 3] = -1.061963e-1
        gamma[5, 4] = -3.57142857e-1
        super().__init__(model, alpha, gamma, b, b_pred=b_pred,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         recompute_target=recompute_target,
                         compensated=compensated, refine=refine,
                         df64_mixed_solve=df64_mixed_solve)


# ---------------------------------------------------------------------------
# Explicit embedded Runge-Kutta family (non-stiff models)
# ---------------------------------------------------------------------------

def _erk_stage_combination(a, b, b_pred, s, dt, eval_F, u, k1=None):
    """Explicit Butcher-tableau stage accumulation shared by the plain,
    FSAL-carrying and sharded ERK steps: stages are ``eval_F(u_i)`` (the
    caller decides how F is evaluated — local stencil, carried first
    stage, or halo-ring + local F), the update uses ``b``, the embedded
    error uses ``b - b_pred``.  Returns ``(u_new, err, k_last)``; ``err``
    is inf when no predictor row is given (nothing reads it), NaN/inf
    stage blowups are mapped to inf so the controller rejects."""
    from ..ops.df64 import DF, df_max_abs, from_scalar

    df64 = isinstance(u, DF)

    def coeff(c):
        # df64: the coefficient c*dt in full double-float (a pre-rounded
        # f32 product would quantize every stage at ~eps32)
        if df64:
            return DF.wrap(*from_scalar(float(c))) * DF(dt)
        return float(c) * dt

    ks = [] if k1 is None else [k1]
    for i in range(len(ks), s):
        u_i = u
        for j in range(i):
            if a[i, j]:
                u_i = u_i + coeff(a[i, j]) * ks[j]
        ks.append(eval_F(u_i))
    u_new = u
    for i in range(s):
        if b[i]:
            u_new = u_new + coeff(b[i]) * ks[i]
    if b_pred is not None:
        diff = None
        for i in range(s):
            c = b[i] - b_pred[i]
            if c:
                term = coeff(c) * ks[i]
                diff = term if diff is None else diff + term
        err = df_max_abs(diff) if df64 else jnp.max(jnp.abs(diff))
        err = jnp.where(jnp.isnan(err) | jnp.isinf(err), jnp.inf, err)
    else:
        err = jnp.asarray(jnp.inf,
                          dtype=jnp.float32 if df64 else u.dtype)
    return u_new, err, ks[s - 1]


class ERK_general(_SchemeBase):
    """Generic s-stage explicit Runge-Kutta scheme with an optional embedded
    error estimate and the same device-resident adaptive controller as the
    ROW family.

    This is the device-resident replacement for the reference's explicit
    ``scipy.integrate.ode`` integrators (dopri5/dop853 — reference
    schemes.py:430-499): stages are pure stencil F evaluations (no Jacobian,
    no banded solve), the whole step — hooks included — traces into one
    jitted function, and the adaptive retry loop is a ``lax.while_loop``
    carrying status codes, so one output step is one device dispatch.  For
    stiff systems (the framework's main audience) prefer the ROW family;
    explicit steps only pay off when dt is accuracy-limited rather than
    stability-limited.

    Butcher arrays: ``a`` strictly lower triangular (s x s), ``b`` the
    update weights, ``b_pred`` the embedded lower-order weights (required
    for ``time_stepping=True``).  ``order`` is the LOWER order of the
    embedded pair — the controller exponent is ``1/(order + 1)``.

    FSAL (first-same-as-last) pairs are detected from the tableau and the
    adaptive loop carries the last stage's F across attempts WITHIN an
    output step (one fewer F eval per attempt); across output steps the
    stepper stays stateless/pure so it composes with scan/vmap/shard_map.
    Subclasses that reroute the fixed step (e.g. the sharded mixin) set
    ``_fsal_capable = False`` — the FSAL loop evaluates ``problem.F``
    directly and would bypass their rerouted step.
    """

    _fsal_capable = True

    def __init__(self, model, a, b, b_pred=None, order=2,
                 time_stepping=False, tol=None, max_iter=None, dt_min=None,
                 safety_factor=0.9, recompute_target=True,
                 compensated=False):
        super().__init__(model)
        # df64 state already carries ~49-bit significands; the f32 Kahan
        # track would be both redundant and DF-incompatible (same guard as
        # ROW_general.__init__)
        self._compensated = compensated and not self._df64
        self._a = np.asarray(a, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        self._b_pred = (None if b_pred is None
                        else np.asarray(b_pred, dtype=np.float64))
        self._s = len(b)
        self._order = int(order)
        self._recompute_target = recompute_target
        self._time_control = time_stepping
        self._tol = tol
        self._safety_factor = safety_factor
        self._max_iter = max_iter
        self._dt_min = dt_min
        self._err_exponent = 1.0 / (self._order + 1)
        self._internal_dt = None
        self._internal_iter = None
        if time_stepping and b_pred is None:
            raise NotImplementedError(
                "time stepping requires the predictor (b_pred) coefficients"
            )
        if time_stepping and tol is None:
            raise ValueError("time_stepping=True requires a tolerance (tol)")

    def _fixed_step_fn(self, problem):
        a, b, b_pred = self._a, self._b, self._b_pred
        s = self._s
        if self._tol is None and not self._time_control:
            b_pred = None  # no controller ever reads the embedded error

        def fixed_step(t, u, helpers, pstack, x, dt):
            u, helpers, pstack, x = problem.apply_hook(t, u, helpers,
                                                       pstack, x)
            u_new, err, _k = _erk_stage_combination(
                a, b, b_pred, s, dt,
                lambda u_i: problem.F(u_i, helpers, pstack, x), u)
            return u_new, helpers, pstack, x, err

        return fixed_step

    def _build_stepper(self, problem):
        fixed_step = self._fixed_step_fn(problem)

        if not self._time_control:
            def stepper(t, u, helpers, pstack, x, dt, internal_dt):
                u2, h2, p2, x2, _ = fixed_step(t, u, helpers, pstack, x, dt)
                u2, h2, p2, x2 = problem.apply_hook(t + dt, u2, h2, p2, x2)
                return (t + dt, u2, h2, p2, x2, internal_dt,
                        jnp.int32(0), jnp.int32(0))
            return jax.jit(stepper)

        # first-same-as-last pairs (DOPRI5, BS32: last stage input == the
        # accepted state): inside the while_loop the last stage's F can be
        # carried as the next attempt's first stage — one fewer F eval per
        # attempt.  Requires a null hook (a hook rewrites u between
        # attempts, invalidating the carried evaluation) and plain
        # accumulation; trajectories are bit-equal to the generic loop.
        a, b, b_pred = self._a, self._b, self._b_pred
        s = self._s
        fsal = (self._fsal_capable and not self._df64
                and b_pred is not None and b[s - 1] == 0.0
                and np.allclose(a[s - 1, :s - 1], b[:s - 1]))
        if (fsal and problem.hook is null_hook
                and self._recompute_target
                and not self._compensated):
            return self._build_fsal_stepper(problem)

        loop = _adaptive_embedded_loop(
            fixed_step, tol=self._tol, safety=self._safety_factor,
            max_iter=self._max_iter, dt_min=self._dt_min,
            compensated=self._compensated,
            exponent=self._err_exponent,
            interpolate=not self._recompute_target,
            precise_time=self._df64)

        def stepper(t, u, helpers, pstack, x, dt, internal_dt):
            (next_t, u2, h2, p2, x2, dt_i, niter,
             status) = loop(t, u, helpers, pstack, x, dt, internal_dt)
            u2, h2, p2, x2 = problem.apply_hook(next_t, u2, h2, p2, x2)
            return next_t, u2, h2, p2, x2, dt_i, niter, status

        return jax.jit(stepper)

    def _build_fsal_stepper(self, problem):
        """Adaptive loop with the FSAL stage carried across attempts (see
        _build_stepper).  On accept the carried k1 becomes the last stage's
        F (== F of the accepted state); on reject the state is unchanged so
        the old k1 stays valid either way."""
        a, b, b_pred = self._a, self._b, self._b_pred
        s = self._s
        tol, safety = self._tol, self._safety_factor
        max_iter, dt_min = self._max_iter, self._dt_min
        expo = self._err_exponent

        def stages(u, helpers, pstack, x, dt, k1):
            return _erk_stage_combination(
                a, b, b_pred, s, dt,
                lambda u_i: problem.F(u_i, helpers, pstack, x), u, k1=k1)

        def stepper(t, u, helpers, pstack, x, dt, internal_dt):
            next_t = t + dt
            eps = 1e-12 * jnp.maximum(jnp.abs(next_t), 1.0)
            k1_0 = problem.F(u, helpers, pstack, x)

            def cond(carry):
                t_, _u, _k1, dt_i, niter, status = carry
                return (t_ < next_t - eps) & (status == 0)

            def body(carry):
                t_, u_, k1, dt_i, niter, status = carry
                remaining = next_t - t_
                clamped = dt_i >= remaining
                dt_eff = jnp.minimum(dt_i, remaining)
                u2, err, k_last = stages(u_, helpers, pstack, x, dt_eff, k1)
                accept = err <= tol
                err_safe = jnp.maximum(err, jnp.finfo(dt_eff.dtype).tiny)
                dt_next = jnp.clip(
                    safety * dt_eff * (tol / err_safe) ** expo,
                    0.1 * dt_eff, 10.0 * dt_eff)
                dt_i = jnp.where(accept & clamped, dt_i, dt_next)
                t_ = jnp.where(accept, t_ + dt_eff, t_)
                u_ = jnp.where(accept, u2, u_)
                k1 = jnp.where(accept, k_last, k1)
                niter = niter + jnp.int32(1)
                if max_iter is not None:
                    status = jnp.where(niter > jnp.int32(max_iter),
                                       jnp.int32(1), status)
                dt_floor = dt_min if dt_min is not None else (
                    1e3 * jnp.finfo(dt_eff.dtype).tiny
                    + 2.0 * jnp.finfo(dt_eff.dtype).eps * jnp.abs(next_t)
                )
                status = jnp.where(dt_i < dt_floor, jnp.int32(2), status)
                return (t_, u_, k1, dt_i, niter, status)

            carry = (t, u, k1_0, jnp.minimum(internal_dt, dt),
                     jnp.int32(0), jnp.int32(0))
            _t2, u2, _k1, dt_i, niter, status = jax.lax.while_loop(
                cond, body, carry)
            return next_t, u2, helpers, pstack, x, dt_i, niter, status

        return jax.jit(stepper)

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        """Advance the system from t to t+dt (one output step; any number of
        adaptive internal steps happen on-device)."""
        periodic = bool(pars.get("periodic", False))
        stepper = self._get_stepper(hook, periodic)
        u, helpers, pstack, x = self._split(fields, pars)
        internal_dt = self._internal_dt
        if internal_dt is None:
            internal_dt = _seed_internal_dt(self, dt)
        t2, u2, h2, p2, x2, dt_i, niter, status = stepper(
            jnp.asarray(t, dtype=u.dtype), u, helpers, pstack, x,
            jnp.asarray(dt, dtype=u.dtype), jnp.asarray(internal_dt, u.dtype),
        )
        status = int(status)
        if status == 1:
            raise RuntimeError(
                "explicit RK internal iteration above max iterations "
                "authorized"
            )
        if status == 2:
            raise RuntimeError(
                "explicit RK internal time step less than authorized"
            )
        self._internal_dt = float(dt_i)
        self._internal_iter = int(niter)
        return float(t2), self._rebuild(fields, u2, h2, x2)


class RK4(ERK_general):
    """Classic 4th-order Runge-Kutta, fixed dt (no embedded estimate; wrap
    in :func:`time_stepping` for Richardson-based adaptivity)."""

    def __init__(self, model, compensated=False):
        a = np.array([[0, 0, 0, 0],
                      [1 / 2, 0, 0, 0],
                      [0, 1 / 2, 0, 0],
                      [0, 0, 1, 0]])
        b = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])
        super().__init__(model, a, b, time_stepping=False,
                         compensated=compensated)


class BS32(ERK_general):
    """Bogacki-Shampine 3(2) embedded pair — the low-cost adaptive explicit
    choice (4 stages; scipy's RK23)."""

    def __init__(self, model, time_stepping=True, tol=1e-2, max_iter=None,
                 dt_min=None, safety_factor=0.9, recompute_target=True,
                 compensated=False):
        a = np.array([[0, 0, 0, 0],
                      [1 / 2, 0, 0, 0],
                      [0, 3 / 4, 0, 0],
                      [2 / 9, 1 / 3, 4 / 9, 0]])
        b = np.array([2 / 9, 1 / 3, 4 / 9, 0])
        b_pred = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])
        super().__init__(model, a, b, b_pred=b_pred, order=2,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         safety_factor=safety_factor,
                         recompute_target=recompute_target,
                         compensated=compensated)


class DOPRI5(ERK_general):
    """Dormand-Prince 5(4) embedded pair — parity with the reference's
    ``scipy_ode(..., integrator='dopri5')`` (reference schemes.py:430-443),
    stepping on-device instead of through scipy's Fortran loop."""

    def __init__(self, model, time_stepping=True, tol=1e-2, max_iter=None,
                 dt_min=None, safety_factor=0.9, recompute_target=True,
                 compensated=False):
        a = np.zeros((7, 7))
        a[1, 0] = 1 / 5
        a[2, :2] = [3 / 40, 9 / 40]
        a[3, :3] = [44 / 45, -56 / 15, 32 / 9]
        a[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
        a[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                    -5103 / 18656]
        a[6, :6] = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                    11 / 84]
        b = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                      11 / 84, 0])
        b_pred = np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640,
                           -92097 / 339200, 187 / 2100, 1 / 40])
        super().__init__(model, a, b, b_pred=b_pred, order=4,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         safety_factor=safety_factor,
                         recompute_target=recompute_target,
                         compensated=compensated)


# ---------------------------------------------------------------------------
# Theta scheme
# ---------------------------------------------------------------------------

class Theta(_SchemeBase):
    """One-step theta scheme: theta=0 forward Euler, 1 backward Euler,
    0.5 Crank-Nicolson.  Semi-implicit linearized step, J frozen at the
    current state (reference schemes.py:502-559); the sparse LU of the
    reference is replaced by the banded BCR solve."""

    def __init__(self, model, theta=1, solver=None, df64_mixed_solve=None):
        super().__init__(model)
        self._theta = theta
        self._solver = solver  # optional custom (A_bands, B, periodic) -> x
        # df64 models only: n > 0 replaces the full-df64 linear solve with
        # f32-preconditioned df64-residual refinement (same knob, default
        # and accuracy class as the ROW family's df64_mixed_solve)
        self._df64_mixed = ((0 if df64_mixed_solve is None
                             else int(df64_mixed_solve))
                            if self._df64 else 0)

    def _fixed_step_fn(self, problem):
        theta = self._theta
        periodic = problem.periodic
        solver = self._solver

        df64 = self._df64

        def fixed_step(t, u, helpers, pstack, x, dt):
            u, helpers, pstack, x = problem.apply_hook(t, u, helpers, pstack, x)
            if df64:
                from ..ops.banded_df import (axpy_bands_df,
                                             banded_matvec_df,
                                             factor_banded_df)
                from ..ops.df64 import DF

                F = problem.F(u, helpers, pstack, x)
                dt_df = DF(dt)
                if theta == 0:
                    u2 = u + dt_df * F
                else:
                    J = problem.J_bands(u, helpers, pstack, x)
                    th_dt = float(theta) * dt_df
                    B = dt_df * F - th_dt * banded_matvec_df(J, u, periodic) \
                        + u
                    mixed = getattr(self, "_df64_mixed", 0)
                    if mixed:
                        solve = _df64_mixed_solver(
                            J, th_dt, float(theta) * dt, mixed, periodic)
                        u2 = solve(B)
                    else:
                        u2 = factor_banded_df(
                            axpy_bands_df(1.0, -th_dt, J), periodic).solve(B)
                return u2, helpers, pstack, x, jnp.zeros((), jnp.float32)
            F = problem.F(u, helpers, pstack, x)
            if theta == 0:
                u2 = u + dt * F
            else:
                J = problem.J_bands(u, helpers, pstack, x)
                B = dt * (F - theta * banded_matvec(J, u, periodic)) + u
                if solver is None:
                    u2 = factor_linearized(1.0, -theta * dt, J,
                                           periodic).solve(B)
                else:
                    u2 = solver(axpy_bands(1.0, -theta * dt, J), B, periodic)
            return u2, helpers, pstack, x, jnp.zeros((), dtype=u.dtype)

        return fixed_step

    def _build_stepper(self, problem):
        fixed_step = self._fixed_step_fn(problem)

        def stepper(t, u, helpers, pstack, x, dt, internal_dt):
            u2, h2, p2, x2, _err = fixed_step(t, u, helpers, pstack, x, dt)
            u2, h2, p2, x2 = problem.apply_hook(t + dt, u2, h2, p2, x2)
            return (t + dt, u2, h2, p2, x2, internal_dt,
                    jnp.int32(0), jnp.int32(0))

        return jax.jit(stepper)

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        periodic = bool(pars.get("periodic", False))
        stepper = self._get_stepper(hook, periodic)
        u, helpers, pstack, x = self._split(fields, pars)
        t2, u2, h2, p2, x2, *_ = stepper(
            jnp.asarray(t, dtype=u.dtype), u, helpers, pstack, x,
            jnp.asarray(dt, dtype=u.dtype), jnp.asarray(dt, dtype=u.dtype),
        )
        return float(t2), self._rebuild(fields, u2, h2, x2)


# ---------------------------------------------------------------------------
# universal adaptive wrapper (step doubling)
# ---------------------------------------------------------------------------

class DeviceTimeStepping(_SchemeBase):
    """Richardson/step-doubling error control for schemes without a built-in
    estimator (reference schemes.py:33-66), run entirely on-device: the
    accept/reject loop is a ``lax.while_loop`` whose body compares one
    coarse step of ``dt`` against a ``lax.scan`` of ``m`` fine steps of
    ``dt/m``, so an output step is one dispatch no matter how many internal
    attempts it takes (the host-loop formulation pays ~(m+1) dispatches,
    each with a host sync, per accepted step).

    err = max over variables of ``||coarse - fine||_ord / (m^2 - 1)``;
    the attempt is rejected when the controller asks for a shrink beyond
    ``reject_factor``; failures surface as status codes (2: dt underflow),
    raised on the host like the ROW controller."""

    def __init__(self, scheme, tol=1e-1, ord=2, m=10, reject_factor=2):
        super().__init__(scheme._model)
        self._inner = scheme
        self._tol = tol
        self._ord = ord
        self._m = m
        self._reject_factor = reject_factor
        self._time_control = True
        self._seed_with_dt = True  # first coarse attempt = the output dt
        self._internal_dt = None
        self._internal_iter = None

    def _split(self, fields, pars):
        # the wrapped scheme may re-place the state (e.g. sharded schemes
        # commit the arrays to the mesh) — delegate so placement survives
        return self._inner._split(fields, pars)

    def _norm(self, diff):
        # reference semantics: np.linalg.norm(coarse - fine, ord) per
        # dependent variable, max over variables; diff is (nvar, N)
        from ..ops.df64 import DF

        if isinstance(diff, DF):  # error ESTIMATE: f32 of the df64 value
            diff = diff.hi + diff.lo
        if self._ord == np.inf:
            per_var = jnp.max(jnp.abs(diff), axis=-1)
        elif self._ord == 2:
            per_var = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        else:
            per_var = jnp.sum(jnp.abs(diff) ** self._ord, axis=-1) ** (
                1.0 / self._ord)
        return jnp.max(per_var)

    def _build_stepper(self, problem):
        fixed = self._inner._fixed_step_fn(problem)
        tol, m = self._tol, self._m
        reject = self._reject_factor
        mm1 = m * m - 1

        def attempt(t, u, h, p, x_, dt_eff):
            """(coarse vs m-fine) Richardson pair -> (fine state, err)."""
            uc, _hc, _pc, _xc, _e = fixed(t, u, h, p, x_, dt_eff)
            dt_f = dt_eff / m

            def fine(carry, _):
                tf, uf, hf, pf, xf = carry
                uf, hf, pf, xf, _e = fixed(tf, uf, hf, pf, xf, dt_f)
                return (tf + dt_f, uf, hf, pf, xf), None

            (tf, uf, hf, pf, xf), _ = jax.lax.scan(
                fine, (t, u, h, p, x_), length=m)
            err = self._norm(uc - uf) / mm1
            err = jnp.where(jnp.isnan(err) | jnp.isinf(err), jnp.inf, err)
            return uf, hf, pf, xf, err

        def stepper(t, u, helpers, pstack, x, dt, internal_dt):
            next_t = t + dt
            eps = 1e-12 * jnp.maximum(jnp.abs(next_t), 1.0)

            def cond(carry):
                t_, _u, _h, _p, _x, _dt_i, _niter, status = carry
                return (t_ < next_t - eps) & (status == 0)

            def body(carry):
                t_, u_, h_, p_, x_, dt_i, niter, status = carry
                remaining = next_t - t_
                clamped = dt_i >= remaining
                dt_eff = jnp.minimum(dt_i, remaining)
                uf, hf, pf, xf, err = attempt(t_, u_, h_, p_, x_, dt_eff)
                err_safe = jnp.maximum(err, jnp.finfo(dt_eff.dtype).tiny)
                dt_next = jnp.clip(dt_eff * jnp.sqrt(tol / err_safe),
                                   0.1 * dt_eff, 10.0 * dt_eff)
                accept = dt_next >= dt_eff / reject
                t_ = jnp.where(accept, t_ + dt_eff, t_)
                u_ = _tree_where(accept, uf, u_)
                h_ = _tree_where(accept, hf, h_)
                p_ = _tree_where(accept, pf, p_)
                dt_i = jnp.where(accept & clamped, dt_i, dt_next)
                niter = niter + jnp.int32(1)
                dt_floor = (1e3 * jnp.finfo(dt_eff.dtype).tiny
                            + 2.0 * jnp.finfo(dt_eff.dtype).eps
                            * jnp.abs(next_t))
                status = jnp.where(dt_i < dt_floor, jnp.int32(2), status)
                return (t_, u_, h_, p_, x_, dt_i, niter, status)

            carry = (t, u, helpers, pstack, x,
                     jnp.minimum(internal_dt, dt), jnp.int32(0), jnp.int32(0))
            t2, u2, h2, p2, x2, dt_i, niter, status = jax.lax.while_loop(
                cond, body, carry)
            u2, h2, p2, x2 = problem.apply_hook(next_t, u2, h2, p2, x2)
            return next_t, u2, h2, p2, x2, dt_i, niter, status

        return jax.jit(stepper)

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        periodic = bool(pars.get("periodic", False))
        stepper = self._get_stepper(hook, periodic)
        u, helpers, pstack, x = self._split(fields, pars)
        internal_dt = self._internal_dt
        if internal_dt is None:
            internal_dt = dt
        t2, u2, h2, p2, x2, dt_i, niter, status = stepper(
            jnp.asarray(t, dtype=u.dtype), u, helpers, pstack, x,
            jnp.asarray(dt, dtype=u.dtype), jnp.asarray(internal_dt, u.dtype),
        )
        if int(status) == 2:
            raise RuntimeError(
                "step-doubling internal time step less than authorized"
            )
        self._internal_dt = float(dt_i)
        self._internal_iter = int(niter)
        return float(t2), self._rebuild(fields, u2, h2, x2)


def _host_time_stepping(scheme, tol=1e-1, ord=2, m=10, reject_factor=2):
    """Host-loop step doubling for schemes that only exist as host callables
    (scipy_ode, duck-typed hand-written models): same controller as
    DeviceTimeStepping, driven through the ``scheme(t, fields, dt, pars,
    hook)`` surface.

    The adapted step size is carried per TRAJECTORY, keyed on the identity
    of the fields object handed back to the caller: two Simulations sharing
    one wrapped scheme each keep their own dt sequence instead of
    cross-contaminating through a shared slot."""
    carried = {}  # id(fields) -> (weakref, adapted dt)

    def _recall(fields, default):
        entry = carried.pop(id(fields), None)
        if entry is not None:
            ref, h = entry
            if ref() is fields:
                return h
        return default

    def _remember(fields, h):
        try:
            carried[id(fields)] = (weakref.ref(fields), h)
        except TypeError:  # pragma: no cover - non-weakrefable container
            return
        while len(carried) > 64:  # bound abandoned-trajectory entries
            carried.pop(next(iter(carried)))

    def controlled(t, fields, dt, pars, hook=null_hook):
        target = t + dt
        h = _recall(fields, dt)
        while target - t > 1e-10 * max(1.0, abs(target)):
            # clamp only the attempt, not the carried step size: feeding
            # the clamped final sliver back into h would collapse the
            # adapted dt at every output boundary (DeviceTimeStepping's
            # accept&clamped rule, reference wrapper semantics)
            h_eff = min(h, target - t)
            clamped = h_eff < h
            _tc, coarse = scheme(t, fields, h_eff, pars, hook)
            t_f, fine = t, fields
            for _ in range(m):
                t_f, fine = scheme(t_f, fine, h_eff / m, pars, hook)
            err = max(
                np.linalg.norm(
                    np.asarray(coarse[v]) - np.asarray(fine[v]), ord
                ) / (m * m - 1)
                for v in fields.dependent_variables
            )
            h_next = (np.sqrt(h_eff * h_eff * tol / err) if err > 0
                      else 2 * h_eff)
            h_next = float(np.clip(h_next, 0.1 * h_eff, 10.0 * h_eff))
            if h_next < h_eff / reject_factor:
                h = h_next  # rejected: retry the same interval smaller
                continue
            t, fields = t_f, fine
            if not clamped:
                h = h_next
        _remember(fields, h)
        return target, fields

    return controlled


def time_stepping(scheme, tol=1e-1, ord=2, m=10, reject_factor=2):
    """Universal adaptive wrapper around any scheme without built-in error
    control: device-resident ``lax.while_loop`` step doubling when the
    scheme exposes a traceable fixed step, host-loop fallback otherwise
    (reference semantics: schemes.py:33-66)."""
    if isinstance(scheme, _SchemeBase):
        try:
            return DeviceTimeStepping(scheme, tol=tol, ord=ord, m=m,
                                      reject_factor=reject_factor)
        except NotImplementedError:  # pragma: no cover - defensive
            pass
    return _host_time_stepping(scheme, tol=tol, ord=ord, m=m,
                               reject_factor=reject_factor)


# ---------------------------------------------------------------------------
# scipy proxy (host path, compatibility + duck-typed hand-written models)
# ---------------------------------------------------------------------------

class scipy_ode:
    """Proxy around scipy.integrate.ode (vode/BDF/dopri...), running on the
    host through the F/J compatibility wrappers — the path also used by
    duck-typed hand-written models (any object exposing ``.F(fields, pars)``
    and ``fields_template``; reference schemes.py:430-499 and the
    manual_2D_model notebook).

    The integrator sees the interleaved flat state vector; each RHS/Jacobian
    callback scatters it back into a Fields workspace, re-applies the hook
    (so boundary values hold at every internal evaluation) and dispatches to
    the model.

    For compiled Models the device-resident equivalents are faster: the ROW
    family replaces vode/BDF (stiff), :class:`DOPRI5`/:class:`BS32` replace
    dopri5/rk23 (non-stiff) — this proxy remains for scipy-exact oracle
    trajectories and for duck-typed models whose F is host-only code."""

    def __init__(self, model, jac=False, integrator="vode",
                 **integrator_kwargs):
        from scipy.integrate import ode

        self._model = model
        self._solver = ode(self._rhs, jac=self._jacobian if jac else None)
        self._solver.set_integrator(integrator, **integrator_kwargs)

    def _sync(self, t, flat, workspace, pars, hook):
        workspace.fill(flat)
        return hook(t, workspace, pars)

    def _rhs(self, t, flat, workspace, pars, hook):
        fields, pars = self._sync(t, flat, workspace, pars, hook)
        return np.asarray(self._model.F(fields, pars))

    def _jacobian(self, t, flat, workspace, pars, hook):
        fields, pars = self._sync(t, flat, workspace, pars, hook)
        return np.asarray(self._model.J(fields, pars, sparse=False))

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        solver = self._solver
        workspace, pars = hook(t, fields.copy(), pars)
        callback_args = (workspace, pars, hook)
        solver.set_initial_value(np.asarray(workspace.uflat), t)
        solver.set_f_params(*callback_args)
        solver.set_jac_params(*callback_args)
        flat = solver.integrate(t + dt)
        if not solver.successful():
            raise RuntimeError("scipy_ode integrator reported failure")
        workspace.fill(flat)
        workspace, _ = hook(t + dt, workspace, pars)
        return t + dt, workspace
