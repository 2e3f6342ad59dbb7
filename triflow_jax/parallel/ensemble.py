"""Data-parallel ensembles: many simulation instances stepped together.

The reference's only parallelism story is user-orchestrated parameter sweeps
with pickled models (upstream source_doc/source/user_guide.rst:125-138).
Here ensembles are first-class (SURVEY.md §2 strategy table, DP row):

* within one chip, the member axis is a **vmap** over the pure device
  stepper — the banded factorizations and stage solves batch into single
  XLA ops;
* across chips, the member axis is laid out over a ``jax.sharding.Mesh``
  axis (default name "ensemble") with NamedSharding — members never
  communicate, so XLA partitions the whole step with zero collectives.

All members share the time axis (shared-dt ensembles, BASELINE config 5);
adaptive schemes use the max error across members to control the shared dt,
so every member satisfies the tolerance.

df64 models (``Model(..., double="df64")``) run the same vmapped paths on
double-float state: member state is a DF (hi, lo) pytree, F/J/solves
evaluate in double-float, and the adaptive controllers carry compensated
member clocks.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

from ..core import schemes as schemes_mod
from ..core.schemes import null_hook

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def stack_parameters(model, parameter_sets, N, df64=False):
    """Stack a list of parameter dicts (scalars or (N,) arrays) into a
    batched pstack of shape (B, npar, N); with ``df64=True`` the stack is
    built in float64 and split exactly into a DF (hi, lo) pair."""
    backend = model.backend
    dtype = np.float64 if df64 else backend.dtype
    rows = []
    for pars in parameter_sets:
        rows.append(
            np.stack(
                [
                    np.broadcast_to(np.asarray(pars[k], dtype=dtype), (N,))
                    for k in backend.system.pars
                ]
            )
            if backend.system.pars
            else np.zeros((0, N), dtype=dtype)
        )
    stacked = np.stack(rows)
    if df64:
        from ..ops.df64 import DF

        return DF.from_float64(stacked)
    return jnp.asarray(stacked)


def ensemble_sharding(mesh, axis="ensemble"):
    """NamedSharding placing the leading (member) axis on a mesh axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(axis))


def _with_output_hook(stepper, vhook, per_member):
    """Apply the vmapped hook at the OUTPUT time, after the step: the
    scheme-level steppers end every output step with
    ``problem.apply_hook(next_t, ...)`` (core/schemes.py), so the state a
    user observes between steps has the boundary conditions enforced; the
    ensemble steppers get the same semantics through this wrapper (the
    attempt-time hook rides inside the fixed step as usual)."""
    def wrapped(t, u, helpers, pstack, x, dt, internal_dt):
        out = stepper(t, u, helpers, pstack, x, dt, internal_dt)
        if per_member:
            t2, u2, h2, p2, dt_i, status, nb = out
            u2, h2, p2 = vhook(t2, u2, h2, p2, x)
            return t2, u2, h2, p2, dt_i, status, nb
        t2, u2, h2, p2, dt_i, status = out
        u2, h2, p2 = vhook(t2, u2, h2, p2, x)
        return t2, u2, h2, p2, dt_i, status

    return wrapped


def _tree_where_b(pred_b, a, b):
    """Per-member select over matching pytrees: ``pred_b`` is (B,) and the
    leaves carry a leading member axis (covers DF double-float state)."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(
            pred_b.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), a, b)


def _per_member_adaptive_loop(vfixed, B, *, tol, safety, max_iter, dt_min,
                              expo, compensated, interpolate=False,
                              precise_time=False):
    """Masked per-member adaptive while_loop over a batched fixed step.

    ``vfixed(tb, u, helpers, pstack, x, dtb) -> (u2, h2, p2, x, errs)``
    with member-local clocks ``tb`` (B,), step sizes ``dtb`` (B,) and
    per-member embedded errors ``errs`` (B,).  Returns ``stepper(t, u,
    helpers, pstack, x, dt, internal_dt) -> (next_t, u2, h2, p2, dtb,
    status, nb)``: every member advances from t to t+dt on its OWN
    error-controlled internal step sequence; converged members freeze
    (masked updates) while stiff members keep retrying.  Shared by the
    vmapped single-chip path and the dp x sp shard-mapped path.  State
    may be any pytree with a leading member axis (DF double-float pairs
    included — selects go through tree_map).

    ``interpolate=True`` is the reference's ``recompute_target=False``
    (schemes.py:213-227) per member: internal steps never clamp to the
    output time — each member overshoots and its state at ``t + dt`` is
    linearly interpolated between its OWN bracketing internal steps.

    ``precise_time=True`` (the df64 path) carries each member's internal
    clock as a compensated (hi, lo) f32 pair — same rationale as
    schemes._adaptive_embedded_loop: plain f32 accumulation quantizes the
    time grid at ~ulp(t)/2 per accepted step, far above df64's ~1e-13."""
    if precise_time:
        from ..ops.df64 import add_f

        def t_make(tb):
            return (tb, jnp.zeros_like(tb))

        def t_rem(tb, next_t):
            return (next_t - tb[0]) - tb[1]

        def t_adv(tb, dt_eff, accept):
            th2, tl2 = add_f(tb[0], tb[1], dt_eff)
            return (jnp.where(accept, th2, tb[0]),
                    jnp.where(accept, tl2, tb[1]))

        def t_val(tb):
            return tb[0] + tb[1]
    else:
        def t_make(tb):
            return tb

        def t_rem(tb, next_t):
            return next_t - tb

        def t_adv(tb, dt_eff, accept):
            return jnp.where(accept, tb + dt_eff, tb)

        def t_val(tb):
            return tb

    def stepper(t, u, helpers, pstack, x, dt, internal_dt):
        next_t = t + dt
        eps = 1e-12 * jnp.maximum(jnp.abs(next_t), 1.0)
        dtype = u.dtype
        tb0 = jnp.full((B,), t, dtype=dtype)
        idt_b = jnp.broadcast_to(internal_dt, (B,))
        dtb0 = idt_b if interpolate else jnp.minimum(idt_b, dt)

        def unpack(carry):
            if interpolate:
                return carry
            tb, u, cu, h, p, dtb, nb, status = carry
            return (tb, None, None, u, cu, h, p, dtb, nb, status)

        def pack(tb, tpb, up, u, cu, h, p, dtb, nb, status):
            if interpolate:
                return (tb, tpb, up, u, cu, h, p, dtb, nb, status)
            return (tb, u, cu, h, p, dtb, nb, status)

        def cond(carry):
            tb = carry[0]
            status = carry[-1]
            return jnp.any(t_rem(tb, next_t) > eps) & (status == 0)

        def body(carry):
            tb, tpb, up, u, cu, h, p, dtb, nb, status = unpack(carry)
            remaining = t_rem(tb, next_t)
            active = remaining > eps
            if interpolate:
                clamped = jnp.zeros((B,), bool)
                dt_eff = dtb
            else:
                clamped = dtb >= remaining
                dt_eff = jnp.minimum(dtb, remaining)
            u2, h2, p2, _x, errs = vfixed(t_val(tb), u, h, p, x, dt_eff)
            accept = (errs <= tol) & active
            err_safe = jnp.maximum(errs, jnp.finfo(dtype).tiny)
            dt_next = jnp.clip(
                safety * dt_eff * (tol / err_safe) ** expo,
                0.1 * dt_eff, 10.0 * dt_eff,
            )
            dtb = jnp.where(active & ~(accept & clamped), dt_next, dtb)
            if interpolate:
                # remember each member's bracketing pre-step snapshot
                tpb = jnp.where(accept, t_val(tb), tpb)
                up = _tree_where_b(accept, u, up)
            tb = t_adv(tb, dt_eff, accept)
            if compensated:
                from ..ops.compensated import kahan_update

                uk, ck = kahan_update(u, cu, u2)
                u = _tree_where_b(accept, uk, u)
                cu = _tree_where_b(accept, ck, cu)
            else:
                u = _tree_where_b(accept, u2, u)
            h = _tree_where_b(accept, h2, h)
            p = _tree_where_b(accept, p2, p)
            nb = nb + active.astype(jnp.int32)
            if max_iter is not None:
                status = jnp.where(
                    jnp.any(active & (nb > jnp.int32(max_iter))),
                    jnp.int32(1), status)
            dt_floor = dt_min if dt_min is not None else (
                1e3 * jnp.finfo(dtype).tiny
                + 2.0 * jnp.finfo(dtype).eps * jnp.abs(next_t)
            )
            still = t_rem(tb, next_t) > eps
            status = jnp.where(jnp.any(still & (dtb < dt_floor)),
                               jnp.int32(2), status)
            return pack(tb, tpb, up, u, cu, h, p, dtb, nb, status)

        carry = pack(t_make(tb0), tb0, u, u,
                     jax.tree_util.tree_map(jnp.zeros_like, u), helpers,
                     pstack, dtb0, jnp.zeros((B,), jnp.int32), jnp.int32(0))
        (tb, tpb, up, u2, _cu, h2, p2, dtb, nb,
         status) = unpack(jax.lax.while_loop(cond, body, carry))
        if interpolate:
            # member-local linear interpolation to next_t between each
            # member's bracketing internal steps (tb >= next_t on exit)
            from ..ops.df64 import DF

            tbv = t_val(tb)
            span = jnp.maximum(tbv - tpb, jnp.finfo(dtype).tiny)
            w = jnp.clip((next_t - tpb) / span, 0.0, 1.0)
            if isinstance(u2, DF):
                # the lerp must run in DF arithmetic: a leaf-wise f32 lerp
                # loses the hi-component rounding (~ulp(hi)/2 ~ 6e-8
                # relative) into nowhere, silently degrading the carried
                # df64 trajectory to f32-class accuracy (the single-grid
                # loop lerps through DF operators — core/schemes.py)
                wb = w.reshape((-1,) + (1,) * (u2.hi.ndim - 1))
                u2 = up + DF(wb) * (u2 - up)
            else:
                u2 = jax.tree_util.tree_map(
                    lambda a, bnew: a + w.reshape(
                        (-1,) + (1,) * (a.ndim - 1)) * (bnew - a), up, u2)
        return next_t, u2, h2, p2, dtb, status, nb

    return stepper


class Ensemble:
    """Batched simulations over a leading member axis.

    Parameters
    ----------
    model : Model
    u0 : (B, nvar, N) initial dependent variables (or (B, N) when nvar == 1)
    parameter_sets : list of B parameter dicts (all sharing 'periodic'),
        or a single dict broadcast to every member
    x : (N,) shared grid
    scheme : scheme class (default schemes.ROS2 — fixed-dt; adaptive ROW
        classes use a shared dt controlled by the max member error)
    hook : traced hook applied per member (at attempt and output time,
        scheme-stepper semantics)
    mesh / mesh_axis : optional device mesh; members are sharded over it
    space_axis : optional second mesh axis carrying every member's grid
        (combined dp x sp on a 2-D mesh — see _build_dp_sp)
    helpers0 : (B, nhelp, N) initial helper functions
    per_member_dt : bool — adaptive schemes only: every member carries its
        own internal clock and step size inside the while_loop (masked
        freezing), instead of the shared dt driven by the max member
        error; ``member_iters`` records each member's attempt count
    **scheme_kwargs : forwarded to the scheme constructor

    Example
    -------
    >>> ens = Ensemble(model, u0, [{'k': k, 'periodic': True} for k in ks], x)
    >>> t, u = ens.run(tmax=1.0, dt=0.1)
    """

    def __init__(self, model, u0, parameter_sets, x, scheme=None,
                 hook=null_hook, mesh=None, mesh_axis="ensemble",
                 space_axis=None, helpers0=None, per_member_dt=False,
                 **scheme_kwargs):
        self.model = model
        backend = model.backend
        nvar = backend.system.nvar
        self._df64 = getattr(model, "precision", None) == "df64"
        if self._df64:
            # df64 member state: exact (hi, lo) split of the f64 input —
            # every vmapped/sharded path below rides the DF pytree (the
            # reference's unconditional f64, model.py:148, composed with
            # the batch axis)
            from ..ops.df64 import DF

            u0 = np.asarray(u0, dtype=np.float64)
            if u0.ndim == 2 and nvar == 1:
                u0 = u0[:, None, :]
            if u0.ndim != 3:
                raise ValueError("u0 must have shape (B, nvar, N)")
            self.B, _, self.N = u0.shape
            u0 = DF.from_float64(u0)
            self.x = DF.from_float64(np.asarray(x, dtype=np.float64))
        else:
            u0 = jnp.asarray(u0, dtype=backend.dtype)
            if u0.ndim == 2 and nvar == 1:
                u0 = u0[:, None, :]
            if u0.ndim != 3:
                raise ValueError("u0 must have shape (B, nvar, N)")
            self.B, _, self.N = u0.shape
            self.x = jnp.asarray(x, dtype=backend.dtype)

        if isinstance(parameter_sets, dict):
            parameter_sets = [parameter_sets] * self.B
        if len(parameter_sets) != self.B:
            raise ValueError("need one parameter dict per member")
        self._parameter_sets = [dict(p) for p in parameter_sets]
        periodic = {bool(p.get("periodic", False)) for p in parameter_sets}
        if len(periodic) != 1:
            raise ValueError("all members must share the periodic flag")
        self.periodic = periodic.pop()
        self.pstack = stack_parameters(model, parameter_sets, self.N,
                                       df64=self._df64)

        nhelp = len(backend.system.help_funcs)
        if self._df64:
            from ..ops.df64 import DF

            if helpers0 is None:
                helpers0 = np.zeros((self.B, nhelp, self.N))
            self.helpers = DF.from_float64(
                np.asarray(helpers0, dtype=np.float64))
        else:
            if helpers0 is None:
                helpers0 = jnp.zeros((self.B, nhelp, self.N), backend.dtype)
            self.helpers = jnp.asarray(helpers0, dtype=backend.dtype)
        self.u = u0
        self.t = 0.0

        scheme = schemes_mod.ROS2 if scheme is None else scheme
        self._scheme = scheme(model, **scheme_kwargs)
        # any scheme with a built-in embedded-error controller (ROW family,
        # explicit RK family) drives the shared/per-member dt machinery;
        # schemes without one (Theta, RK4) step at fixed dt
        self._adaptive = bool(getattr(self._scheme, "_time_control", False))
        self._hook = hook
        self._per_member_dt = bool(per_member_dt) and self._adaptive
        self._internal_dt = None
        self._scan_stepper = None
        self.member_iters = None
        from uuid import uuid1

        self.id = str(uuid1())[:6]
        self._stream = None
        self._container = None
        self._stepper = self._build(mesh, mesh_axis, space_axis)

    # ------------------------------------------------------------------
    def _build(self, mesh, mesh_axis, space_axis=None):
        if space_axis is not None:
            if mesh is None or space_axis not in mesh.shape:
                raise ValueError(
                    "space_axis requires a mesh carrying that axis")
            if mesh.shape[space_axis] > 1:
                return self._build_dp_sp(mesh, mesh_axis, space_axis)
        if self._per_member_dt:
            stepper = self._build_adaptive_per_member()
        elif self._adaptive:
            stepper = self._build_adaptive()
        else:
            fixed = self._scheme.device_fixed_step(self._hook, self.periodic)

            def stepper(t, u, helpers, pstack, x, dt, internal_dt):
                u2, h2, p2, _x, _err = jax.vmap(
                    fixed, in_axes=(None, 0, 0, 0, None, None)
                )(t, u, helpers, pstack, x, dt)
                return t + dt, u2, h2, p2, internal_dt, jnp.int32(0)

        vhook, _ = self._member_hook_fns()
        if vhook is not None:
            stepper = _with_output_hook(stepper, vhook, self._per_member_dt)
        stepper = jax.jit(stepper)
        if mesh is not None:
            sharding = ensemble_sharding(mesh, mesh_axis)
            self.u = jax.device_put(self.u, sharding)
            self.helpers = jax.device_put(self.helpers, sharding)
            self.pstack = jax.device_put(self.pstack, sharding)
        return stepper

    def _build_dp_sp(self, mesh, mesh_axis, space_axis):
        """Combined dp x sp stepper: members shard over ``mesh_axis`` AND
        every member's grid shards over ``space_axis`` — the full 2-D mesh
        layout for sweeps whose grids do not fit one chip.  The per-member
        step is the SpatialModel shard-mapped core (ppermute halo rings +
        distributed SPIKE solve along "space", zero collectives along
        "ensemble"); adaptive schemes run either the generic shared-dt
        controller on the replicated cross-mesh error max, or — with
        ``per_member_dt`` — the masked per-member controller on the (B,)
        member errors (each already pmax-reduced over its space shards).
        Hooks apply at the GLOBAL array level, vmapped over the member
        axis: a Dirichlet scatter lands on the owning shard under GSPMD,
        same as the single-grid sharded path (spatial.py module doc)."""
        from jax.sharding import NamedSharding, PartitionSpec

        from .spatial import SpatialModel

        ndev_e, ndev_s = mesh.shape[mesh_axis], mesh.shape[space_axis]
        if self.B % ndev_e:
            raise ValueError(
                f"B={self.B} must divide the '{mesh_axis}' axis ({ndev_e})")
        sm = SpatialModel(self.model, mesh, axis=space_axis,
                          periodic=self.periodic)
        scheme = self._scheme
        per_member = self._per_member_dt
        df64 = self._df64

        def build_core(pm=False):
            if isinstance(scheme, schemes_mod.ROW_general):
                return sm._row_core(
                    scheme._tables, scheme._s, self.periodic,
                    batch_axis=mesh_axis, per_member=pm, df64=df64,
                    df64_mixed=getattr(scheme, "_df64_mixed", 0) or 2)
            if isinstance(scheme, schemes_mod.ERK_general):
                b_pred = scheme._b_pred if self._adaptive else None
                return sm._erk_core(scheme._a, scheme._b, b_pred, scheme._s,
                                    self.periodic, batch_axis=mesh_axis,
                                    per_member=pm, df64=df64)
            if isinstance(scheme, schemes_mod.Theta):
                return sm._theta_core(
                    scheme._theta, self.periodic, batch_axis=mesh_axis,
                    per_member=pm, df64=df64,
                    df64_mixed=getattr(scheme, "_df64_mixed", 0) or 2)
            raise TypeError(
                f"{type(scheme).__name__} has no sharded implementation "
                "(supported: ROW family, explicit RK family, Theta)")

        vhook, vhook_pm = self._member_hook_fns()

        if per_member:
            core = build_core(pm=True)

            def pm_fixed(tb, u, h, p, x, dtb):
                if vhook_pm is not None:
                    u, h, p = vhook_pm(tb, u, h, p, x)
                u2, errs = core(tb, u, h, p, x, dtb)
                return u2, h, p, x, errs

            stepper = _per_member_adaptive_loop(
                pm_fixed, self.B, tol=scheme._tol,
                safety=scheme._safety_factor, max_iter=scheme._max_iter,
                dt_min=scheme._dt_min,
                expo=getattr(scheme, "_err_exponent", 0.5),
                compensated=scheme._compensated,
                interpolate=not getattr(scheme, "_recompute_target", True),
                precise_time=df64)
            if vhook is not None:
                stepper = _with_output_hook(stepper, vhook, True)
            return jax.jit(self._finish_dp_sp(mesh, mesh_axis, space_axis,
                                              stepper))

        core = build_core()
        if self._adaptive:
            def batch_fixed(t, u, h, p, x, dt):
                if vhook is not None:
                    u, h, p = vhook(t, u, h, p, x)
                u2, err = core(t, u, h, p, x, dt)
                return u2, h, p, x, err

            loop = schemes_mod._adaptive_embedded_loop(
                batch_fixed, tol=scheme._tol, safety=scheme._safety_factor,
                max_iter=scheme._max_iter, dt_min=scheme._dt_min,
                compensated=scheme._compensated,
                exponent=getattr(scheme, "_err_exponent", 0.5),
                interpolate=not getattr(scheme, "_recompute_target", True),
                precise_time=df64)

            def stepper(t, u, helpers, pstack, x, dt, internal_dt):
                (next_t, u2, h2, p2, _x, dt_i, _niter,
                 status) = loop(t, u, helpers, pstack, x, dt, internal_dt)
                return next_t, u2, h2, p2, dt_i, status
        else:
            def stepper(t, u, helpers, pstack, x, dt, internal_dt):
                if vhook is not None:
                    u, helpers, pstack = vhook(t, u, helpers, pstack, x)
                u2, _err = core(t, u, helpers, pstack, x, dt)
                return (t + dt, u2, helpers, pstack, internal_dt,
                        jnp.int32(0))

        if vhook is not None:
            stepper = _with_output_hook(stepper, vhook, False)
        return jax.jit(self._finish_dp_sp(mesh, mesh_axis, space_axis,
                                          stepper))

    def _member_hook_fns(self):
        """(vhook, vhook_pm): the reference-style ``hook(t, fields, pars)``
        lifted to pure array form (schemes._DeviceProblem.apply_hook) and
        vmapped over the member axis — t shared vs member-local clocks.
        (None, None) for the null hook."""
        if self._hook is null_hook:
            return None, None
        problem = schemes_mod._DeviceProblem(self.model, self._hook,
                                             self.periodic,
                                             df64=self._df64)

        def member_hook(t, u, h, p, x):
            u2, h2, p2, _x = problem.apply_hook(t, u, h, p, x)
            return u2, h2, p2

        return (jax.vmap(member_hook, in_axes=(None, 0, 0, 0, None)),
                jax.vmap(member_hook, in_axes=(0, 0, 0, 0, None)))

    def _finish_dp_sp(self, mesh, mesh_axis, space_axis, stepper):
        """Lay the member state out over the 2-D mesh and return the
        stepper unchanged (placement is a side effect on self)."""
        from jax.sharding import NamedSharding, PartitionSpec

        state_sh = NamedSharding(
            mesh, PartitionSpec(mesh_axis, None, space_axis))
        self.u = jax.device_put(self.u, state_sh)
        self.helpers = jax.device_put(self.helpers, state_sh)
        self.pstack = jax.device_put(self.pstack, state_sh)
        self.x = jax.device_put(
            self.x, NamedSharding(mesh, PartitionSpec(space_axis)))
        return stepper

    def _build_adaptive(self):
        """Shared-dt adaptive loop: the scheme's generic embedded-error
        controller (schemes._adaptive_embedded_loop) wrapped around the
        vmapped fixed step with the error max-reduced over members — every
        member meets the tolerance, one lax.while_loop for the batch."""
        scheme = self._scheme
        fixed = scheme.device_fixed_step(self._hook, self.periodic)
        vfixed = jax.vmap(fixed, in_axes=(None, 0, 0, 0, None, None))

        def batch_fixed(t, u, h, p, x, dt):
            u2, h2, p2, _x, errs = vfixed(t, u, h, p, x, dt)
            return u2, h2, p2, x, jnp.max(errs)

        loop = schemes_mod._adaptive_embedded_loop(
            batch_fixed, tol=scheme._tol, safety=scheme._safety_factor,
            max_iter=scheme._max_iter, dt_min=scheme._dt_min,
            compensated=scheme._compensated,
            exponent=getattr(scheme, "_err_exponent", 0.5),
            interpolate=not getattr(scheme, "_recompute_target", True),
            precise_time=self._df64)

        def stepper(t, u, helpers, pstack, x, dt, internal_dt):
            (next_t, u2, h2, p2, _x, dt_i, _niter,
             status) = loop(t, u, helpers, pstack, x, dt, internal_dt)
            return next_t, u2, h2, p2, dt_i, status

        return stepper

    def _build_adaptive_per_member(self):
        """Per-member adaptive loop (SURVEY.md §7 phase 7, "hard part 3"):
        every member carries its OWN clock and step size in one
        lax.while_loop; converged members freeze (masked updates) while
        stiff members keep retrying.  A heterogeneous sweep no longer pays
        the stiffest member's dt on every member — member m's internal step
        count is what ITS tolerance demands, and an accepted step is never
        re-done because some other member rejected (the shared-dt
        controller discards the whole batch attempt on any reject)."""
        fixed = self._scheme.device_fixed_step(self._hook, self.periodic)
        vfixed = jax.vmap(fixed, in_axes=(0, 0, 0, 0, None, 0))
        return _per_member_adaptive_loop(
            vfixed, self.B, tol=self._scheme._tol,
            safety=self._scheme._safety_factor,
            max_iter=self._scheme._max_iter, dt_min=self._scheme._dt_min,
            expo=getattr(self._scheme, "_err_exponent", 0.5),
            compensated=self._scheme._compensated,
            interpolate=not getattr(self._scheme, "_recompute_target", True),
            precise_time=self._df64)


    # ------------------------------------------------------------------
    def _set_internal_dt(self, dt_i):
        self._internal_dt = (np.asarray(dt_i)
                             if getattr(dt_i, "ndim", 0) else float(dt_i))

    def step(self, dt):
        """Advance every member by dt (output clocks stay shared; with
        ``per_member_dt`` the internal stepping is member-local)."""
        backend = self.model.backend
        if self._df64:
            # quantize the requested dt to its f32 device value so the f64
            # host clock accumulates exactly the dt the state integrates
            # with (same boundary rule as Simulation.__init__)
            dt = float(np.float32(dt))
        internal_dt = self._internal_dt
        if internal_dt is None:
            internal_dt = schemes_mod._seed_internal_dt(self._scheme, dt)
        out = self._stepper(
            jnp.asarray(self.t, backend.dtype), self.u, self.helpers,
            self.pstack, self.x, jnp.asarray(dt, backend.dtype),
            jnp.asarray(internal_dt, backend.dtype),
        )
        if self._per_member_dt:
            t2, u2, h2, p2, dt_i, status, nb = out
            self.member_iters = np.asarray(nb)
        else:
            t2, u2, h2, p2, dt_i, status = out
        status = int(status)
        if status == 1:
            raise RuntimeError(
                "Rosenbrock internal iteration above max iterations authorized"
            )
        if status == 2:
            raise RuntimeError("Rosenbrock internal time step less than authorized")
        # df64: keep the host output clock in f64 (the device t2 is an f32
        # scalar; dt was quantized above so host and device agree)
        self.t = self.t + dt if self._df64 else float(t2)
        self.u, self.helpers, self.pstack = u2, h2, p2
        self._set_internal_dt(dt_i)
        self._emit()
        return self.t, self.u

    def steps(self, n, dt):
        """Advance every member by n output steps of dt in ONE device call
        (a lax.scan over the stepper).  Every call pays a host sync —
        scanning many steps per call is how production runs amortize it
        (same pattern as the Simulation driver's device loop)."""
        backend = self.model.backend
        if self._df64:
            dt = float(np.float32(dt))   # see step()
        internal_dt = self._internal_dt
        if internal_dt is None:
            internal_dt = schemes_mod._seed_internal_dt(self._scheme, dt)
        if self._scan_stepper is None:
            stepper = self._stepper
            per_member = self._per_member_dt
            B = self.B

            adaptive = self._adaptive
            compensated = (self._scheme._compensated and not adaptive)

            def scan_run(t, u, h, p, x, dt, internal_dt, n):
                def step_once(i, t, u, cu, h, p, dt_i, status, nb):
                    out = stepper(t, u, h, p, x, dt, dt_i)
                    if per_member:
                        t2, u2, h2, p2, dt_i2, st2, nb2 = out
                        nb = nb + nb2
                    else:
                        t2, u2, h2, p2, dt_i2, st2 = out
                    if compensated:
                        # Kahan-compensate the per-step increments across
                        # the scan (the adaptive steppers compensate inside
                        # their own while_loops)
                        from ..ops.compensated import kahan_update

                        u2, cu = kahan_update(u, cu, u2)
                    return (i + jnp.int32(1), t2, u2, cu, h2, p2, dt_i2,
                            jnp.maximum(status, st2), nb)

                carry = (jnp.int32(0), t, u, jnp.zeros_like(u), h, p,
                         internal_dt, jnp.int32(0),
                         jnp.zeros((B,), jnp.int32))
                if adaptive:
                    # early-exit while_loop (no per-step outputs are
                    # stacked): once any member trips a status code the
                    # remaining output steps are NOT computed on garbage
                    # state
                    def cond(c):
                        i = c[0]
                        status = c[-2]
                        return (i < n) & (status == 0)

                    final = jax.lax.while_loop(
                        cond, lambda c: step_once(*c), carry)
                else:
                    # fixed-dt: status is constant 0 — keep lax.scan
                    # (static trip count pipelines where a while_loop
                    # serializes)
                    final, _ = jax.lax.scan(
                        lambda c, _: (step_once(*c), ()), carry, length=n)
                i_, t2, u2, _cu, h2, p2, dti2, st2, nb2 = final
                return t2, u2, h2, p2, dti2, st2, nb2

            self._scan_stepper = jax.jit(scan_run, static_argnums=(7,))
        idt = jnp.asarray(internal_dt, backend.dtype)
        if self._per_member_dt:
            idt = jnp.broadcast_to(idt, (self.B,))
        t2, u2, h2, p2, dt_i, status, nb = self._scan_stepper(
            jnp.asarray(self.t, backend.dtype), self.u, self.helpers,
            self.pstack, self.x, jnp.asarray(dt, backend.dtype),
            idt, int(n),
        )
        if self._per_member_dt:
            self.member_iters = np.asarray(nb)
        status = int(status)
        if status == 1:
            raise RuntimeError(
                "Rosenbrock internal iteration above max iterations authorized"
            )
        if status == 2:
            raise RuntimeError(
                "Rosenbrock internal time step less than authorized")
        self.t = self.t + int(n) * dt if self._df64 else float(t2)
        self.u, self.helpers, self.pstack = u2, h2, p2
        self._set_internal_dt(dt_i)
        self._emit()
        return self.t, self.u

    def run(self, tmax, dt, steps_per_call=None):
        """Run to tmax.  With ``steps_per_call`` the loop scans that many
        steps per device call (recommended for production: amortizes the
        per-call dispatch).  The final step is clamped so the run lands
        exactly on tmax even when it is not a multiple of dt."""
        eps = 1e-12 * max(1.0, abs(tmax))
        if self._df64:
            dt = float(np.float32(dt))   # see step()
        if steps_per_call and steps_per_call > 1:
            while True:
                n_full = int(np.floor((tmax - self.t) / dt + 1e-9))
                if n_full < 1:
                    break
                self.steps(min(int(steps_per_call), n_full), dt)
        while self.t < tmax - eps:
            self.step(min(dt, tmax - self.t))
        if self._container is not None:
            self._container.flush()
        return self.t, self.u

    # ------------------------------------------------- observability (L5)
    def _emit(self):
        if self._stream is not None:
            self._stream.emit(self)

    @property
    def stream(self):
        """Push-based event stream emitting this Ensemble after every
        host-visible advance: each ``step(dt)``, and once per scanned
        ``steps(n, dt)`` chunk (scanned chunks do not stack intermediate
        states, same tradeoff as ``Simulation.run(device_chunk=...)``)."""
        if self._stream is None:
            from ..utils.streams import Stream

            self._stream = Stream()
        return self._stream

    @property
    def container(self):
        return self._container

    def attach_container(self, path=None, save="all", mode="w",
                         nbuffer=50, force=False):
        """Persist the WHOLE sweep into one container: every frame carries
        a ``member`` axis, so ``retrieve(path).data[var]`` has shape
        (T, B, N).  The reference's sweep persistence is one container per
        pickled-model process (user_guide.rst:125-138); here the batch is
        a single device computation, so it is a single container with the
        member parameter values recorded in the metadata."""
        from ..plugins.container import Container, TimeSeries

        metadata = {"B": self.B, "N": self.N, "periodic": self.periodic,
                    "ensemble": True}
        keys = sorted({k for p in self._parameter_sets for k in p}
                      - {"periodic"})
        for k in keys:
            metadata[k] = [p.get(k) for p in self._parameter_sets]
        self._container = Container(
            "%s/%s" % (path, self.id) if path else None,
            save=save,
            mode=mode,
            metadata=metadata,
            force=force,
            nbuffer=nbuffer,
        )
        self._container.connect(
            self.stream,
            snapshot=lambda ens: TimeSeries.from_ensemble_state(
                ens.t, ens, metadata),
        )
        self._emit()       # initial frame (parity with the Simulation loop)
        return self._container

    # --------------------------------------------------- checkpointing (L5)
    def save_checkpoint(self, path):
        """One-call restartable snapshot of the whole sweep (t, member
        states, helpers, shared or per-member internal dt, member
        parameter sets) — see utils/checkpoint.py."""
        from ..utils.checkpoint import save_ensemble_checkpoint

        return save_ensemble_checkpoint(path, self)

    @staticmethod
    def from_checkpoint(path, model, **kwargs):
        """Rebuild an Ensemble from a checkpoint file and the (re)built
        model; extra kwargs (scheme, tol, per_member_dt, ...) forwarded."""
        from ..utils.checkpoint import load_ensemble_checkpoint

        return load_ensemble_checkpoint(path, model, **kwargs)
