"""Simulation driver: the user-facing time loop.

API parity with upstream triflow/core/simulation.py:58-438 — an
iterable yielding ``(t, fields)`` every output ``dt`` until ``tmax``, with
hooks, post-processes, a stream fan-out for persistence/visualization,
per-step timers and a status lifecycle — while the numerical work between two
outputs stays resident on the device (the scheme's internal adaptive loop is
a single jitted call, SURVEY.md §7 phase 6).

The scheme-wrapping quirk of the reference (an instance compared against
classes, simulation.py:190-197, which made the universal ``time_stepping``
wrapper apply to *every* scheme) is implemented by intent: only schemes
without built-in error control get wrapped.
"""

from __future__ import annotations

import inspect
import logging
import pprint
import time
import warnings
from collections import namedtuple
from datetime import datetime, timedelta
from uuid import uuid1

import numpy as np

from . import schemes
from ..utils.streams import Stream

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def is_interactive():
    import __main__ as main

    return not hasattr(main, "__file__")


def _get_tqdm():
    import tqdm as _tqdm

    if is_interactive():
        try:
            return _tqdm.tqdm_notebook
        except AttributeError:
            return _tqdm.tqdm
    return _tqdm.tqdm


def null_hook(t, fields, pars):
    return fields, pars


class Timer:
    """Wall/CPU timing of the scheme calls (reference simulation.py:32-47)."""

    def __init__(self, last, total):
        self.last = last
        self.total = total

    @staticmethod
    def _fmt(seconds):
        return str(timedelta(seconds=float(seconds)))

    def __repr__(self):
        return "last:   {last}\ntotal:  {total}".format(
            last=self._fmt(self.last), total=self._fmt(self.total)
        )


PostProcess = namedtuple("PostProcess", ["name", "function", "description"])


class Simulation(object):
    """High-level container running a model through time.

    Parameters (parity: reference simulation.py:160-200)
    ----------
    model : triflow_jax.Model (or any duck-typed object with F/fields_template)
    fields : Fields or mapping of initial conditions
    parameters : dict (must carry the 'periodic' key for compiled models)
    dt : float — output time step
    t : float — initial time
    tmax : float or None — stop time (None: infinite iterator)
    id : str — simulation name (generated if omitted)
    hook : callable (t, fields, pars) -> (fields, pars), traced into the
        device step; must be jax-compatible (pure, functional updates)
    scheme : scheme class (default schemes.RODASPR)
    time_stepping : bool — adaptive internal time stepping
    mesh : jax.sharding.Mesh or None — when given, the grid is sharded
        over ``mesh_axis`` and every step (stencils, SPIKE banded solves,
        adaptive dt control with cross-shard error reduction, hooks) runs
        distributed; the rest of the driver surface (iterate, run,
        container, checkpoint, timers) is unchanged
    mesh_axis : str — mesh axis carrying the grid (default "space")
    **kwargs : extra args filtered by signature and passed to the scheme

    Examples
    --------
    >>> import numpy as np
    >>> import triflow_jax as triflow
    >>> model = triflow.Model(["k1 * dxxU", "k2 * dxxV"],
    ...                       ["U", "V"], ["k1", "k2"])
    >>> x = np.linspace(0, 100, 1000, endpoint=False)
    >>> U = np.cos(x * 2 * np.pi / 100)
    >>> V = np.sin(x * 2 * np.pi / 100)
    >>> fields = model.fields_template(x=x, U=U, V=V)
    >>> pars = {'k1': 1, 'k2': 1, 'periodic': True}
    >>> simulation = triflow.Simulation(model, fields, pars, dt=5., tmax=50.)
    >>> for t, fields in simulation:
    ...    pass
    >>> print(t)
    50.0
    """

    def __init__(self, model, fields, parameters, dt, t=0, tmax=None,
                 id=None, hook=null_hook, scheme=schemes.RODASPR,
                 time_stepping=True, mesh=None, mesh_axis="space", **kwargs):

        def intersection_kwargs(kwargs, function):
            func_parameters = inspect.signature(function).parameters
            return {k: v for k, v in kwargs.items() if k in func_parameters}

        kwargs["time_stepping"] = time_stepping
        if mesh is not None:
            from ..parallel.spatial import SpatialModel

            spatial = SpatialModel(
                model, mesh, axis=mesh_axis,
                periodic=bool(parameters.get("periodic", False)),
            )
            scheme = spatial.scheme_class(scheme)
        self.id = str(uuid1())[:6] if not id else id
        self.model = model
        self.parameters = dict(parameters)
        if hasattr(fields, "keys") and not isinstance(fields, dict):
            self.fields = model.fields_template(**{k: fields[k] for k in fields.keys()})
        else:
            self.fields = model.fields_template(**fields)
        # keep the state device-resident from the start so hooks can rely on
        # jax array semantics (.at[...].set(...)) both on the host and traced
        if hasattr(model, "backend"):
            import jax
            import jax.numpy as jnp
            import numpy as _np

            if getattr(model, "precision", None) == "df64":
                # df64 runs keep the HOST state at full float64; the scheme
                # splits it into (hi, lo) f32 pairs at the device boundary
                # (_SchemeBase._split_df64).  jnp f64 arrays when x64 is on
                # (hooks keep .at semantics), numpy otherwise.
                host = (jnp if jax.config.jax_enable_x64 else _np)
                for key in self.fields.keys():
                    self.fields[key] = host.asarray(self.fields[key],
                                                    dtype=_np.float64)
            else:
                dtype = model.backend.dtype
                for key in self.fields.keys():
                    self.fields[key] = jnp.asarray(self.fields[key],
                                                   dtype=dtype)
        self.t = t
        if getattr(model, "precision", None) == "df64":
            # the device step consumes dt as an f32 scalar; quantize the
            # REQUESTED dt to that value up front so the (f64) host clock
            # accumulates exactly the dt the state integrates with —
            # otherwise a non-representable dt (e.g. 0.01) would mislabel
            # the trajectory by ~2e-8 * t, swamping df64's ~1e-13
            import numpy as _np

            dt = float(_np.float32(dt))
        self.user_dt = self.dt = dt
        self.tmax = tmax
        self.i = 0
        self._stream = Stream()
        self._pprocesses = []

        self._scheme = scheme(
            model, **intersection_kwargs(kwargs, scheme.__init__)
        )
        # any scheme carrying its own adaptive controller (ROW and explicit
        # RK families with time_stepping=True) must not be double-wrapped in
        # the universal step-doubling wrapper (the reference's membership
        # test got this wrong — SURVEY.md §2 "implement the intent")
        has_builtin_control = bool(getattr(self._scheme, "_time_control",
                                           False))
        if time_stepping and not has_builtin_control:
            self._scheme = schemes.time_stepping(
                self._scheme,
                **intersection_kwargs(kwargs, schemes.time_stepping),
            )
        self.status = "created"

        self._total_running = 0
        self._last_running = 0
        self._created_timestamp = datetime.now()
        self._started_timestamp = None
        self._last_timestamp = None
        self._actual_timestamp = datetime.now()
        self._hook = hook
        self._container = None
        self._iterator = self.compute()

    # ------------------------------------------------------------------ loop
    def _compute_one_step(self, t, fields, pars):
        """One output step: hook, clamp dt against tmax, scheme call, timers
        (reference simulation.py:210-226)."""
        if not (getattr(self.model, "precision", None) == "df64"
                and isinstance(fields["x"], np.ndarray)):
            # df64 on a non-x64 backend keeps host fields as numpy f64,
            # which lacks jax .at semantics — skip the (idempotent) host
            # re-application; the hook still runs traced inside the device
            # step at attempt and output time (schemes apply_hook)
            fields, pars = self._hook(t, fields, pars)
        self.dt = (
            self.tmax - t
            if self.tmax and (t + self.dt >= self.tmax)
            else self.dt
        )
        before_compute = time.monotonic()
        t, fields = self._scheme(t, fields, self.dt, pars, hook=self._hook)
        after_compute = time.monotonic()
        self._last_running = after_compute - before_compute
        self._total_running += self._last_running
        self._last_timestamp = self._actual_timestamp
        self._actual_timestamp = datetime.now()
        return t, fields, pars

    def compute(self):
        """Generator yielding the system state every dt
        (reference simulation.py:228-266)."""
        fields = self.fields
        t = self.t
        pars = self.parameters
        self._started_timestamp = datetime.now()
        self.stream.emit(self)
        self.status = "running"

        try:
            while True:
                if self.tmax and np.isclose(t, self.tmax):
                    self._end_simulation()
                    return

                t, fields, pars = self._compute_one_step(t, fields, pars)

                self.i += 1
                self.t = t
                self.fields = fields
                self.parameters = pars
                for pprocess in self.post_processes:
                    pprocess.function(self)
                self.stream.emit(self)
                yield self.t, self.fields

        except RuntimeError:
            self.status = "failed"
            # persist whatever was buffered before surfacing the failure
            if self.container:
                try:
                    self.container.flush()
                except Exception:  # noqa: BLE001 - best effort on teardown
                    logger.exception("container flush failed during teardown")
            raise

    def _end_simulation(self):
        self.status = "finished"
        if self.container:
            self.container.flush()
            self.container.merge()

    def run(self, progress=True, verbose=False, device_chunk=1):
        """Compute all steps (reference simulation.py:268-295).  Careful: if
        tmax is not set, this never returns.

        ``device_chunk > 1`` scans that many output steps per device call
        (hooks run traced inside the step) and emits each snapshot to the
        stream/post-processes afterwards — the observable sequence is
        unchanged, but the host sync per call is amortized."""
        if (device_chunk and device_chunk > 1 and self.tmax
                and hasattr(self._scheme, "device_steps")):
            return self._run_chunked(progress, verbose, int(device_chunk))
        total_iter = int((self.tmax // self.user_dt) if self.tmax else 0)
        log = logger.info if verbose else logger.debug
        t, fields = self.t, self.fields
        ran = False
        if progress:
            tqdm = _get_tqdm()
            with tqdm(
                initial=(self.i if self.i < total_iter else total_iter),
                total=total_iter,
            ) as pbar:
                for t, fields in self:
                    ran = True
                    pbar.update(1)
                    log("%s running: t: %g" % (self.id, t))
        else:
            for t, fields in self:
                ran = True
                log("%s running: t: %g" % (self.id, t))
        if not ran:
            warnings.warn("Simulation already ended")
        return t, fields

    #: cap on the per-call stacked-snapshot bytes of the chunked scan (the
    #: scan stacks device_chunk full states on the device)
    _CHUNK_SNAPSHOT_BYTES = 1 << 30

    def _chunk_cap(self):
        state_bytes = sum(
            int(np.asarray(self.fields[k]).nbytes) for k in self.fields.keys()
        )
        return max(1, self._CHUNK_SNAPSHOT_BYTES // max(state_bytes, 1))

    def _run_chunked(self, progress, verbose, device_chunk):
        """Scan-chunked run: full-dt steps in device chunks, the final
        partial step (dt clamped to hit tmax) through the normal loop.
        Chunks are additionally capped so the scan's stacked snapshots stay
        within _CHUNK_SNAPSHOT_BYTES of device memory."""
        log = logger.info if verbose else logger.debug
        total_iter = int(round(self.tmax / self.user_dt))
        pbar = None
        if progress:
            tqdm = _get_tqdm()
            pbar = tqdm(initial=min(self.i, total_iter), total=total_iter)
        if self.status == "created":
            self.stream.emit(self)
            self.status = "running"
        device_chunk = min(device_chunk, self._chunk_cap())
        first_chunk = True
        try:
            while True:
                remaining = self.tmax - self.t
                if remaining <= 1e-12 * max(1.0, abs(self.tmax)):
                    break
                n_full = int(np.floor(remaining / self.dt + 1e-9))
                if n_full < 1:
                    break
                n = min(device_chunk, n_full)
                before = time.monotonic()
                try:
                    t2, snapshots, status = self._scheme.device_steps(
                        self.t, self.fields, n, self.dt, self.parameters,
                        hook=self._hook)
                except RuntimeError:
                    raise
                except Exception:
                    # a host-side (untraceable) hook fails at trace time:
                    # fall back to the stepwise loop, which applies it on
                    # the host
                    if not first_chunk:
                        raise
                    warnings.warn(
                        "device_chunk run failed at trace time (host-only "
                        "hook?); falling back to the stepwise loop")
                    if pbar is not None:
                        pbar.close()
                        pbar = None
                    return self.run(progress=progress, verbose=verbose,
                                    device_chunk=1)
                first_chunk = False
                elapsed = time.monotonic() - before
                self._last_running = elapsed / n
                self._total_running += elapsed
                # emit every valid snapshot (on failure: the prefix computed
                # before the failing step) so the container keeps them
                for t_i, fields_i in snapshots:
                    self.i += 1
                    self.t = t_i
                    self.fields = fields_i
                    for pprocess in self.post_processes:
                        pprocess.function(self)
                    self.stream.emit(self)
                    if pbar is not None:
                        pbar.update(1)
                    log("%s running: t: %g" % (self.id, self.t))
                if status == 1:
                    raise RuntimeError(
                        "Rosenbrock internal iteration above max iterations "
                        "authorized")
                if status == 2:
                    raise RuntimeError(
                        "Rosenbrock internal time step less than authorized")
            # chunk snapshots are bulk-fetched host arrays; restore jax
            # array semantics (hooks rely on .at[...] functional updates)
            # for the stepwise tail and any later host-side stepping
            if hasattr(self.model, "backend"):
                import jax.numpy as jnp

                dtype = self.model.backend.dtype
                for key in self.fields.keys():
                    self.fields[key] = jnp.asarray(self.fields[key],
                                                   dtype=dtype)
            # final partial step (if tmax is not a multiple of dt)
            while not np.isclose(self.t, self.tmax):
                t, fields, pars = self._compute_one_step(
                    self.t, self.fields, self.parameters)
                self.i += 1
                self.t, self.fields, self.parameters = t, fields, pars
                for pprocess in self.post_processes:
                    pprocess.function(self)
                self.stream.emit(self)
                if pbar is not None:
                    pbar.update(1)
            self._end_simulation()
        except RuntimeError:
            self.status = "failed"
            if self.container:
                try:
                    self.container.flush()
                except Exception:  # noqa: BLE001 - best effort on teardown
                    logger.exception("container flush failed during teardown")
            raise
        finally:
            if pbar is not None:
                pbar.close()
        return self.t, self.fields

    # ------------------------------------------------------------- plumbing
    def attach_container(self, path=None, save="all", mode="w",
                         nbuffer=50, force=False):
        """Attach a persistence container fed from the stream
        (reference simulation.py:352-381)."""
        from ..plugins.container import Container

        self._container = Container(
            "%s/%s" % (path, self.id) if path else None,
            save=save,
            mode=mode,
            metadata=self.parameters,
            force=force,
            nbuffer=nbuffer,
        )
        self._container.connect(self.stream)
        return self._container

    # --------------------------------------------------------- checkpointing
    def save_checkpoint(self, path):
        """One-call restartable snapshot (t, i, dt, adaptive internal dt,
        fields, parameters) — see utils/checkpoint.py."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(path, self)

    @staticmethod
    def from_checkpoint(path, model, **kwargs):
        """Rebuild a Simulation from a checkpoint file and the (re)built
        model; extra kwargs (hook, scheme, tol, ...) forwarded."""
        from ..utils.checkpoint import load_checkpoint

        return load_checkpoint(path, model, **kwargs)

    @property
    def post_processes(self):
        return self._pprocesses

    @property
    def stream(self):
        return self._stream

    @property
    def container(self):
        return self._container

    @property
    def timer(self):
        return Timer(self._last_running, self._total_running)

    def add_post_process(self, name, post_process, description=""):
        """Register a per-step callback taking the simulation state
        (reference simulation.py:399-432)."""
        self._pprocesses.append(
            PostProcess(name=name, function=post_process, description=description)
        )
        self._pprocesses[-1].function(self)

    def remove_post_process(self, name):
        self._pprocesses = [
            pp for pp in self._pprocesses if pp.name != name
        ]

    def __repr__(self):
        def stamp(ts):
            return ts.isoformat(" ", "seconds") if ts else "never"

        header = f" Simulation {self.id} ".center(40, "=")
        lines = [
            header,
            f"status      {self.status}",
            f"created     {stamp(self._created_timestamp)}",
            f"started     {stamp(self._started_timestamp)}",
            f"last step   {stamp(self._last_timestamp)}",
            "",
            f"t           {self.t:g}" + (f" / tmax {self.tmax:g}"
                                         if self.tmax else ""),
            f"iteration   {self.i}",
            f"timing      last {self._last_running:g}s, "
            f"total {self._total_running:g}s",
            "",
            "parameters:",
        ]
        lines += [
            f"  {key:<10} {pprint.pformat(value)}"
            for key, value in self.parameters.items()
        ]
        try:
            hook_src = inspect.getsource(self._hook).rstrip()
        except (OSError, TypeError):
            hook_src = repr(self._hook)
        if self._hook is not null_hook:
            lines += ["", "hook:", *("  " + ln for ln in hook_src.splitlines())]
        lines += ["", "model:", str(self.model), "=" * 40]
        return "\n".join(lines)

    def __iter__(self):
        return self.compute()

    def __next__(self):
        return next(self._iterator)
