"""Compiler backends: lower the discretized symbolic system to executable
array functions.

The primary backend is JAX/XLA (``JaxBackend``) — it replaces the reference's
Theano graph compiler (upstream triflow/core/compilers.py:11-178).  A
NumPy backend (``NumpyBackend``) mirrors the reference's second compiler
(compilers.py:181-332) and serves as an independent oracle in tests.

Differences from the reference driven by the XLA compilation model:

* the RHS ``F`` is evaluated as a struct-of-arrays ``(nvar, N)`` tensor — the
  interleaved ``[U0, V0, U1, V1, ...]`` layout of the reference
  (compilers.py:110-111) is produced only by the host-compat wrappers;
* the Jacobian is emitted **directly into a banded layout**
  ``(window, nvar, nvar, N)`` instead of an in-graph CSC assembly
  (compilers.py:131-176): the sparsity is structurally banded and known at
  trace time, so no argsort/indptr machinery is needed and the result feeds
  the device-resident banded solver (ops/banded.py);
* the periodic/edge boundary mode is a **static compile-time flag** (two XLA
  specializations) instead of the reference's runtime ``ifelse(periodic,...)``
  branch (compilers.py:83-86).
"""

from __future__ import annotations

from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np
import sympy as sp
from sympy import Symbol

from .symbolic import DiscreteSystem, offset_symbol


def _make_minmax_modules(xp, printer_module):
    """Custom lowering for Max/Min/Heaviside (the reference installs similar
    replacements, compilers.py:30-43 / 195-205 — minus the always-1 Heaviside
    bug, which we fix to the mathematical definition)."""

    def _max(*args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = args[0]
        return reduce(xp.maximum, args)

    def _min(*args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = args[0]
        return reduce(xp.minimum, args)

    def _heaviside(a, *h0):
        return xp.heaviside(a, h0[0] if h0 else 0.5)

    return [
        {"Max": _max, "Min": _min, "amax": _max, "amin": _min,
         "Heaviside": _heaviside},
        printer_module,
    ]


def shift(arr, off: int, halo: int, periodic: bool, xp=jnp):
    """Array of ``arr[i + off]`` with boundary closure.

    periodic: wrap-around (reference pad: compilers.py:76-79), lowered to a
    single roll which XLA fuses into the consuming stencil.
    edge: clamp to the edge value with ``halo`` ghost copies
    (compilers.py:80-82).  ``off`` and ``halo`` are static Python ints.
    """
    if off == 0:
        return arr
    if periodic:
        return xp.roll(arr, -off, axis=-1)
    pad = [(0, 0)] * (arr.ndim - 1) + [(halo, halo)]
    padded = xp.pad(arr, pad, mode="edge")
    n = arr.shape[-1]
    return padded[..., halo + off: halo + off + n]


class ArrayBackend:
    """Compiled functions for one model over a generic array module.

    Public (pure) entry points — all take:
      u       : (nvar, N)  dependent variables
      helpers : (nhelp, N) helper functions
      pstack  : (npar, N)  per-node parameter values
      x       : (N,)       grid
      periodic: bool       STATIC boundary mode
    """

    xp = np
    printer_module = "numpy"
    name = "numpy"

    def __init__(self, system: DiscreteSystem, dtype=np.float64):
        self.system = system
        self.dtype = dtype
        lo, hi = system.bounds
        self.halo = system.halo
        self.window = system.window

        # argument convention shared by every lambdified expression; mirrors
        # Model._symbolic_args ordering
        # (upstream triflow/core/model.py:317-328)
        all_vars = tuple(system.dep_vars) + tuple(system.help_funcs)
        self._offset_args = [
            (var, off) for off in range(lo, hi + 1) for var in all_vars
        ]
        self.args_symbols = (
            [Symbol("x")]
            + [offset_symbol(v, o) for v, o in self._offset_args]
            + [Symbol(p) for p in system.pars]
            + [Symbol("dx")]
        )

        modules = _make_minmax_modules(self.xp, self.printer_module)
        self._F_fns = [
            sp.lambdify(self.args_symbols, expr, modules=modules)
            for expr in system.F_exprs
        ]
        self._J_fns = {
            key: sp.lambdify(self.args_symbols, expr, modules=modules)
            for key, expr in system.J_band_exprs.items()
        }
        self._finalize()

    def _finalize(self):
        self.F = self.F_impl
        self.J_bands = self.J_bands_impl

    # ------------------------------------------------------------------ utils
    def _eval_args(self, u, helpers, pstack, x, periodic: bool):
        """Positional argument list for the lambdified expressions."""
        named = {}
        for i, name in enumerate(self.system.dep_vars):
            named[name] = u[..., i, :]
        for i, name in enumerate(self.system.help_funcs):
            named[name] = helpers[..., i, :]
        N = x.shape[-1]
        dx = (x[..., -1] - x[..., 0]) / (N - 1)
        args = [x]
        for var, off in self._offset_args:
            args.append(shift(named[var], off, self.halo, periodic, self.xp))
        for i, _p in enumerate(self.system.pars):
            args.append(pstack[..., i, :])
        args.append(dx)
        return args, N

    def _broadcast(self, value, like):
        xp = self.xp
        value = xp.asarray(value, dtype=self.dtype)
        return xp.broadcast_to(value, like)

    # ------------------------------------------------------------------- F
    def F_impl(self, u, helpers, pstack, x, *, periodic: bool):
        """RHS of the dynamical system, shape (..., nvar, N)."""
        args, N = self._eval_args(u, helpers, pstack, x, periodic)
        like = jnp.broadcast_shapes(u.shape[:-2], x.shape[:-1]) + (N,)
        rows = [self._broadcast(fn(*args), like) for fn in self._F_fns]
        return self.xp.stack(rows, axis=-2)

    # ------------------------------------------------------------------- J
    def J_bands_impl(self, u, helpers, pstack, x, *, periodic: bool):
        """Banded Jacobian, shape (..., window, nvar, nvar, N):

        ``bands[k, m, n, i] = dF_m(node i) / d u_n(node i + k - halo)``

        For the edge (non-periodic) closure, ghost-node dependencies are
        folded onto the boundary columns (the reference achieves the same by
        clamping CSC column indices, whose duplicate COO entries are summed —
        compilers.py:131-147)."""
        xp = self.xp
        args, N = self._eval_args(u, helpers, pstack, x, periodic)
        nvar = self.system.nvar
        W = self.window
        batch = jnp.broadcast_shapes(u.shape[:-2], x.shape[:-1])
        like = batch + (N,)
        rows = {}
        for (m, n, k), fn in self._J_fns.items():
            rows[(k, m, n)] = self._broadcast(fn(*args), like)
        zero = xp.zeros(like, dtype=self.dtype)
        bands = xp.stack(
            [
                xp.stack(
                    [
                        xp.stack(
                            [rows.get((k, m, n), zero) for n in range(nvar)],
                            axis=-2,
                        )
                        for m in range(nvar)
                    ],
                    axis=-3,
                )
                for k in range(W)
            ],
            axis=-4,
        )
        if not periodic:
            bands = fold_edges(bands, self.halo, xp)
        return bands

    # ------------------------------------------------- extended-array entry
    # (domain decomposition: the caller supplies arrays already padded with
    # `halo` ghost cells per side — from a shard_map halo exchange — and the
    # expressions are evaluated on the interior slice without any internal
    # boundary closure)
    def _eval_args_ext(self, u_ext, helpers_ext, pstack, x, dx):
        h = self.halo
        named = {}
        for i, name in enumerate(self.system.dep_vars):
            named[name] = u_ext[..., i, :]
        for i, name in enumerate(self.system.help_funcs):
            named[name] = helpers_ext[..., i, :]
        N = u_ext.shape[-1] - 2 * h
        args = [x]
        for var, off in self._offset_args:
            args.append(named[var][..., h + off: h + off + N])
        for i, _p in enumerate(self.system.pars):
            args.append(pstack[..., i, :])
        args.append(dx)
        return args, N

    def F_ext_impl(self, u_ext, helpers_ext, pstack, x, dx):
        """RHS over pre-haloed arrays; returns (..., nvar, N_interior)."""
        args, N = self._eval_args_ext(u_ext, helpers_ext, pstack, x, dx)
        like = jnp.broadcast_shapes(u_ext.shape[:-2], x.shape[:-1]) + (N,)
        rows = [self._broadcast(fn(*args), like) for fn in self._F_fns]
        return self.xp.stack(rows, axis=-2)

    def J_bands_ext_impl(self, u_ext, helpers_ext, pstack, x, dx):
        """Banded Jacobian over pre-haloed arrays (no edge folding — the
        caller owns the global boundary closure)."""
        xp = self.xp
        args, N = self._eval_args_ext(u_ext, helpers_ext, pstack, x, dx)
        nvar = self.system.nvar
        W = self.window
        batch = jnp.broadcast_shapes(u_ext.shape[:-2], x.shape[:-1])
        like = batch + (N,)
        rows = {}
        for (m, n, k), fn in self._J_fns.items():
            rows[(k, m, n)] = self._broadcast(fn(*args), like)
        zero = xp.zeros(like, dtype=self.dtype)
        return xp.stack(
            [
                xp.stack(
                    [
                        xp.stack(
                            [rows.get((k, m, n), zero) for n in range(nvar)],
                            axis=-2,
                        )
                        for m in range(nvar)
                    ],
                    axis=-3,
                )
                for k in range(W)
            ],
            axis=-4,
        )

    # ------------------------------------------------------- df64 entry
    # (double-float precision: state/F/J as (hi, lo) f32 pairs — ~49-bit
    # effective significand from f32 arithmetic; see ops/df64.py.  An
    # alternative to the reference's native-f64 compute, model.py:148.)
    def _df64_lambdified(self):
        from ..ops.df64 import LAMBDIFY_MODULES

        if getattr(self, "_df64_fns", None) is None:
            F_fns = [
                sp.lambdify(self.args_symbols, expr, modules=LAMBDIFY_MODULES)
                for expr in self.system.F_exprs
            ]
            J_fns = {
                key: sp.lambdify(self.args_symbols, expr,
                                 modules=LAMBDIFY_MODULES)
                for key, expr in self.system.J_band_exprs.items()
            }
            self._df64_fns = (F_fns, J_fns)
        return self._df64_fns

    def _eval_args_df64(self, u, helpers, pstack, x, periodic: bool):
        """df64 twin of _eval_args: every argument is a DF pair; shifts are
        structural and applied to hi/lo componentwise (exact)."""
        from ..ops.df64 import df_map

        def df_shift(df, off):
            if off == 0:
                return df
            if periodic:
                return df_map(lambda a: jnp.roll(a, -off, axis=-1), df)

            def edge(a):
                pad = [(0, 0)] * (a.ndim - 1) + [(self.halo, self.halo)]
                padded = jnp.pad(a, pad, mode="edge")
                n = a.shape[-1]
                return padded[..., self.halo + off: self.halo + off + n]

            return df_map(edge, df)

        named = {}
        for i, name in enumerate(self.system.dep_vars):
            named[name] = u[..., i, :]
        for i, name in enumerate(self.system.help_funcs):
            named[name] = helpers[..., i, :]
        N = x.shape[-1]
        dx = (x[..., -1] - x[..., 0]) / (N - 1)
        args = [x]
        for var, off in self._offset_args:
            args.append(df_shift(named[var], off))
        for i, _p in enumerate(self.system.pars):
            args.append(pstack[..., i, :])
        args.append(dx)
        return args, N

    def _as_df_row(self, val, like_shape):
        from ..ops.df64 import DF, df_broadcast_to, from_scalar

        if not isinstance(val, DF):
            if isinstance(val, (int, float)):
                val = DF.wrap(*from_scalar(val))  # exact split of constants
            else:
                val = DF(jnp.asarray(val, jnp.float32))
        return df_broadcast_to(val, like_shape)

    def F_df64(self, u, helpers, pstack, x, *, periodic: bool):
        """df64 RHS: DF (..., nvar, N) from DF inputs."""
        from ..ops.df64 import df_stack

        F_fns, _ = self._df64_lambdified()
        args, N = self._eval_args_df64(u, helpers, pstack, x, periodic)
        like = jnp.broadcast_shapes(u.shape[:-2], x.shape[:-1]) + (N,)
        rows = [self._as_df_row(fn(*args), like) for fn in F_fns]
        return df_stack(rows, axis=-2)

    def _eval_args_ext_df64(self, u_ext, helpers_ext, pstack, x, dx):
        """df64 twin of _eval_args_ext: pre-haloed DF arrays (a shard_map
        halo exchange supplies the ghost cells componentwise — structural,
        so the DF pairs stay exact); offsets are interior slices."""
        h = self.halo
        named = {}
        for i, name in enumerate(self.system.dep_vars):
            named[name] = u_ext[..., i, :]
        for i, name in enumerate(self.system.help_funcs):
            named[name] = helpers_ext[..., i, :]
        N = u_ext.shape[-1] - 2 * h
        args = [x]
        for var, off in self._offset_args:
            args.append(named[var][..., h + off: h + off + N])
        for i, _p in enumerate(self.system.pars):
            args.append(pstack[..., i, :])
        args.append(dx)
        return args, N

    def F_ext_df64(self, u_ext, helpers_ext, pstack, x, dx):
        """df64 RHS over pre-haloed DF arrays -> DF (..., nvar, N_int)."""
        from ..ops.df64 import df_stack

        F_fns, _ = self._df64_lambdified()
        args, N = self._eval_args_ext_df64(u_ext, helpers_ext, pstack, x, dx)
        like = jnp.broadcast_shapes(u_ext.shape[:-2], x.shape[:-1]) + (N,)
        rows = [self._as_df_row(fn(*args), like) for fn in F_fns]
        return df_stack(rows, axis=-2)

    def J_bands_ext_df64(self, u_ext, helpers_ext, pstack, x, dx):
        """df64 banded Jacobian over pre-haloed DF arrays (no edge folding
        — the caller owns the global boundary closure, exactly as
        J_bands_ext_impl)."""
        from ..ops.df64 import df_stack, df_zeros

        _, J_fns = self._df64_lambdified()
        args, N = self._eval_args_ext_df64(u_ext, helpers_ext, pstack, x, dx)
        nvar = self.system.nvar
        W = self.window
        batch = jnp.broadcast_shapes(u_ext.shape[:-2], x.shape[:-1])
        like = batch + (N,)
        rows = {}
        for (m, n, k), fn in J_fns.items():
            rows[(k, m, n)] = self._as_df_row(fn(*args), like)
        zero = df_zeros(like)
        return df_stack(
            [
                df_stack(
                    [
                        df_stack(
                            [rows.get((k, m, n), zero) for n in range(nvar)],
                            axis=-2,
                        )
                        for m in range(nvar)
                    ],
                    axis=-3,
                )
                for k in range(W)
            ],
            axis=-4,
        )

    def J_bands_df64(self, u, helpers, pstack, x, *, periodic: bool):
        """df64 banded Jacobian: DF (..., window, nvar, nvar, N)."""
        from ..ops.df64 import df_stack, df_zeros

        _, J_fns = self._df64_lambdified()
        args, N = self._eval_args_df64(u, helpers, pstack, x, periodic)
        nvar = self.system.nvar
        W = self.window
        batch = jnp.broadcast_shapes(u.shape[:-2], x.shape[:-1])
        like = batch + (N,)
        rows = {}
        for (m, n, k), fn in J_fns.items():
            rows[(k, m, n)] = self._as_df_row(fn(*args), like)
        zero = df_zeros(like)
        bands = df_stack(
            [
                df_stack(
                    [
                        df_stack(
                            [rows.get((k, m, n), zero) for n in range(nvar)],
                            axis=-2,
                        )
                        for m in range(nvar)
                    ],
                    axis=-3,
                )
                for k in range(W)
            ],
            axis=-4,
        )
        if not periodic:
            # fold_edges only uses functional .at updates, which DF mirrors
            bands = fold_edges(bands, self.halo, jnp)
        return bands

    # --------------------------------------------------- host-side helpers
    def pack_pars(self, pars: dict, x):
        """Broadcast scalar/per-node parameters to an (npar, N) stack
        (reference broadcast: routines.py:40-43)."""
        N = np.shape(x)[-1]
        xp = self.xp
        rows = [
            xp.broadcast_to(xp.asarray(pars[key], dtype=self.dtype), (N,))
            for key in self.system.pars
        ]
        if not rows:
            return xp.zeros((0, N), dtype=self.dtype)
        return xp.stack(rows)

    def split_fields(self, fields):
        """Extract (u, helpers, x) arrays from a Fields container."""
        xp = self.xp
        N = fields.size
        if self.system.dep_vars:
            u = xp.stack(
                [xp.asarray(fields[k], dtype=self.dtype) for k in self.system.dep_vars]
            )
        else:
            u = xp.zeros((0, N), self.dtype)
        if self.system.help_funcs:
            helpers = xp.stack(
                [xp.asarray(fields[k], dtype=self.dtype) for k in self.system.help_funcs]
            )
        else:
            helpers = xp.zeros((0, N), dtype=self.dtype)
        x = xp.asarray(fields["x"], dtype=self.dtype)
        return u, helpers, x


def fold_edges(bands, halo: int, xp=jnp):
    """Fold out-of-domain band entries onto the clamped boundary columns.

    Left edge: at node i < halo, the entry for offset (k - halo) with
    i + k - halo < 0 actually multiplies u(0); add it to the band element that
    maps node i to column 0 (band index halo - i) and zero the original.
    Right edge symmetric.  ``bands`` has shape (..., W, nvar, nvar, N).
    """
    h = halo
    W = bands.shape[-4]
    if xp is np:
        bands = np.array(bands)
        for i in range(h):
            for k in range(h - i):
                bands[..., h - i, :, :, i] += bands[..., k, :, :, i]
                bands[..., k, :, :, i] = 0.0
            for k in range(h - i):
                koff = W - 1 - k
                bands[..., h + i, :, :, -1 - i] += bands[..., koff, :, :, -1 - i]
                bands[..., koff, :, :, -1 - i] = 0.0
        return bands
    for i in range(h):
        for k in range(h - i):
            bands = bands.at[..., h - i, :, :, i].add(bands[..., k, :, :, i])
            bands = bands.at[..., k, :, :, i].set(0.0)
        for k in range(h - i):
            koff = W - 1 - k
            bands = bands.at[..., h + i, :, :, -1 - i].add(
                bands[..., koff, :, :, -1 - i]
            )
            bands = bands.at[..., koff, :, :, -1 - i].set(0.0)
    return bands


class NumpyBackend(ArrayBackend):
    """Pure-NumPy oracle backend (reference analog: numpy_compiler,
    compilers.py:181-332)."""


class JaxBackend(ArrayBackend):
    """JAX/XLA backend — the device path: F and the Jacobian bands are
    shifted-slice stencils that XLA fuses."""

    xp = jnp
    printer_module = "jax"
    name = "jax"

    def _finalize(self):
        self.F = jax.jit(self.F_impl, static_argnames=("periodic",))
        self.J_bands = jax.jit(self.J_bands_impl, static_argnames=("periodic",))


# ---------------------------------------------------------------------------
# banded -> scipy sparse (host-side compatibility path)
# ---------------------------------------------------------------------------

def bands_to_csc(bands, periodic: bool):
    """Assemble the (N*nvar, N*nvar) scipy CSC matrix from the banded layout,
    interleaved node-major ordering (row = i * nvar + m), matching the
    reference Jacobian layout (compilers.py:131-168).

    Host-only: used by the J_Routine parity wrapper and by tests; the device
    solvers consume the bands directly.  ``bands`` must already have its edge
    folding applied (duplicate entries are summed anyway, which makes clamped
    assembly and folded assembly equivalent).
    """
    import scipy.sparse as sps

    bands = np.asarray(bands)
    W, nvar, _, N = bands.shape
    h = W // 2
    rows, cols, vals = [], [], []
    for k in range(W):
        for m in range(nvar):
            for n in range(nvar):
                band = bands[k, m, n]
                i = np.arange(N)
                j = i + (k - h)
                if periodic:
                    j = j % N
                else:
                    mask = (j >= 0) & (j < N)
                    i, j, band = i[mask], j[mask], band[mask]
                rows.append(i * nvar + m)
                cols.append(j * nvar + n)
                vals.append(band)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return sps.csc_matrix((vals, (rows, cols)), shape=(N * nvar, N * nvar))
