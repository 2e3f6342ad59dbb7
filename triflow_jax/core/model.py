"""Model: symbolic 1D PDE system discretized in space, compiled to fast
device-resident routines.

API parity with upstream triflow/core/model.py:83-584 (constructor
signature, ``F``/``J`` routine attributes, ``F_array``/``J_array`` symbolic
arrays, ``fields_template``, ``save``/``load``, pickling) — the compilation
target is JAX/XLA instead of Theano-generated C.

Examples
--------
A simple diffusion equation:

>>> from triflow_jax import Model
>>> model = Model("k * dxxU", "U", "k")

A coupled system of convection-diffusion equations:

>>> model = Model(["k1 * dxxU - c1 * dxV",
...                "k2 * dxxV - c2 * dxU"],
...               ["U", "V"], ["k1", "k2", "c1", "c2"])
"""

from __future__ import annotations

import logging
from pickle import dump, load

import jax
import jax.numpy as jnp
import numpy as np
import sympy as sp

from . import fields as fields_mod
from .compiler import JaxBackend, NumpyBackend
from .routines import F_Routine, J_Routine
from .symbolic import build_discrete_system, offset_symbol

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def _coerce(arg):
    if arg is None:
        return tuple()
    if isinstance(arg, str):
        return (arg,)
    return tuple(arg)


def _resolve_dtype(double):
    if double == "df64":
        # double-float: state/compute as (hi, lo) f32 pairs (ops/df64.py);
        # the backend's component dtype is f32, effective precision ~2^-48
        return jnp.float32
    if double and jax.config.jax_enable_x64:
        return jnp.float64
    if double:
        logger.info(
            "float64 requested but jax x64 mode is disabled; using float32 "
            "(set JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', True))"
        )
    return jnp.float32


# "theano" (the reference's fast backend, compilers.py:11) is aliased to the
# JAX backend so reference code drops in unchanged.
_BACKENDS = {"jax": JaxBackend, "numpy": NumpyBackend, "theano": JaxBackend}


def _reduce_model(eq_diffs, dep_vars, pars, help_functions, bdc_conditions,
                  compiler, double=True):
    return Model(eq_diffs, dep_vars, pars, help_functions, bdc_conditions,
                 compiler=compiler, double=double)


class Model:
    """Contain the finite-difference approximation and compiled routines of
    the dynamical system ``dtU = F(U)``.

    Parameters (parity with reference model.py:138-150)
    ----------
    differential_equations : str or iterable of str
        RHS of the PDEs; spatial derivatives written as ``dxxU``, ``dx(U, 2)``
        or sympy ``Derivative(U, x, x)``.
    dependent_variables : str or iterable of str
    parameters : str or iterable of str, optional
        scalar or per-node (N,) parameters.
    help_functions : str or iterable of str, optional
        fields that are differenced in space but not evolved in time.
    bdc_conditions : optional
        parsed and discretized for parity, but (as in the reference, where no
        compiler consumes it — model.py:144,234-239) not used by the backends;
        boundary conditions are applied through hooks or the periodic flag.
    compiler : "jax" (default) | "numpy" | callable
        "jax" is the device backend; "numpy" is a pure-NumPy oracle.
        A callable receives the model and must return a backend object.
    simplify, fdiff_jac, double, hold_compilation : see reference semantics.
    high_order : bool, optional (extension)
        unlock centered stencils beyond 4th order (the reference raises
        NotImplementedError above order 4, model.py:437-439 — kept as the
        default contract).

    Attributes
    ----------
    F : F_Routine — interleaved flat RHS, host API.
    J : J_Routine — scipy CSC Jacobian, host API.
    F_array, J_array : numpy object arrays of sympy expressions (parity).
    backend : the compiled device backend (JaxBackend) exposing
        ``F(u, helpers, pstack, x, periodic=...)`` -> (nvar, N) and
        ``J_bands(...)`` -> (window, nvar, nvar, N), both jit-compiled.
    """

    def __init__(
        self,
        differential_equations,
        dependent_variables,
        parameters=None,
        help_functions=None,
        bdc_conditions=None,
        compiler="jax",
        simplify=False,
        fdiff_jac=False,
        double=True,
        hold_compilation=False,
        high_order=False,
    ):
        self._diff_eqs = _coerce(differential_equations)
        self._dep_vars = _coerce(dependent_variables)
        self._pars = _coerce(parameters)
        self._help_funcs = _coerce(help_functions)
        self._bdcs = _coerce(bdc_conditions)
        self._indep_vars = ("x",)
        self._double = double
        self._compiler_name = compiler if isinstance(compiler, str) else compiler
        self._high_order = high_order

        self._nvar = len(self._dep_vars)

        self.system = build_discrete_system(
            self._diff_eqs,
            self._dep_vars,
            self._pars,
            self._help_funcs,
            simplify=simplify,
            fdiff_jac=fdiff_jac,
            high_order=high_order,
        )
        if self._bdcs:
            # parse/discretize for parity; vestigial in the reference too
            build_discrete_system(
                self._bdcs, self._dep_vars, self._pars, self._help_funcs,
                high_order=high_order,
            )

        self._bounds = self.system.bounds
        self._window_range = self.system.window

        # ---- parity symbolic arrays -------------------------------------
        self.F_array = np.array(self.system.F_exprs, dtype=object)
        U = self.system.unknown_symbols()
        lo, hi = self._bounds
        nvar = self._nvar
        # J_array ordered like the reference flatten("F") over (eq, unknown):
        # unknown-major (model.py:279-281)
        J_flat = []
        for off in range(lo, hi + 1):
            for n in range(nvar):
                for m in range(nvar):
                    J_flat.append(
                        self.system.J_band_exprs.get((m, n, off - lo), sp.S.Zero)
                    )
        self.J_array = np.array(J_flat, dtype=object)
        self._sparse_indices = np.where(self.J_array != 0)
        self._J_sparse_array = self.J_array[self._sparse_indices]

        if hold_compilation:
            return
        self.compile(compiler)

    # ------------------------------------------------------------------ API
    def compile(self, compiler="jax"):
        dtype = _resolve_dtype(self._double)
        if isinstance(compiler, str):
            backend_cls = _BACKENDS.get(compiler)
            if backend_cls is None:
                raise ValueError(
                    f"unknown compiler '{compiler}' (available: {sorted(_BACKENDS)})"
                )
            backend = backend_cls(self.system, dtype=dtype)
        else:
            backend = compiler(self)
        self.backend = backend
        var_names = self._dep_vars + self._help_funcs
        self.F = F_Routine(self.F_array, var_names, self._pars, backend)
        self.J = J_Routine(self._J_sparse_array, var_names, self._pars, backend)

    @property
    def fields_template(self):
        return fields_mod.factory1D(self._dep_vars, self._help_funcs)

    @property
    def _args(self):
        return list(map(str, self._symbolic_args))

    @property
    def _symbolic_args(self):
        lo, hi = self._bounds
        all_vars = self._dep_vars + self._help_funcs
        discrete = [
            offset_symbol(var, off)
            for off in range(lo, hi + 1)
            for var in all_vars
        ]
        return [
            sp.Symbol("x"),
            *discrete,
            *[sp.Symbol(p) for p in self._pars],
            sp.Symbol("dx"),
        ]

    @property
    def precision(self):
        """'df64' (double-float pairs), 'f64' (native x64) or 'f32'.

        ``double=True`` is the reference's native-f64 request
        (reference triflow/core/model.py:148); ``double="df64"``
        carries a ~49-bit effective significand as (hi, lo) f32 pairs
        computed with f32 arithmetic (ops/df64.py)."""
        if self._double == "df64":
            return "df64"
        if not hasattr(self, "backend"):  # hold_compilation=True
            return "f64" if (self._double and jax.config.jax_enable_x64) \
                else "f32"
        return "f64" if self.backend.dtype == jnp.float64 else "f32"

    # convenience aliases used throughout the device-side code
    @property
    def halo(self):
        return self.system.halo

    @property
    def window(self):
        return self.system.window

    @property
    def dtype(self):
        return self.backend.dtype

    # -------------------------------------------------------------- persist
    def save(self, filename):
        """Save the model as a binary pickle file (parity: model.py:330-343)."""
        with open(filename, "wb") as f:
            dump(self, f)

    @staticmethod
    def load(filename):
        """Load a saved model; the symbolic build is re-run from the equation
        strings and the routines re-jitted (parity: model.py:361-378 — the
        reference's __reduce__ does the same re-build, model.py:579-583; XLA's
        persistent compilation cache plays the role of Theano's disk cache)."""
        with open(filename, "rb") as f:
            return load(f)

    def __reduce__(self):
        compiler = self._compiler_name if isinstance(self._compiler_name, str) else "jax"
        return (
            _reduce_model,
            (self._diff_eqs, self._dep_vars, self._pars, self._help_funcs,
             self._bdcs, compiler, self._double),
        )

    def __repr__(self):
        template = """{equations}

Variables
---------
unknowns:       {vars}
helpers:        {helps}
parameters:     {pars}"""
        return template.format(
            vars=", ".join(self._dep_vars),
            helps=", ".join(self._help_funcs) if self._help_funcs else None,
            equations="\n".join(self._diff_eqs),
            pars=", ".join(self._pars) if self._pars else None,
        )

    # parity helpers used by tests/docs
    @property
    def _symb_diff_eqs(self):
        from .symbolic import generate_sympify_namespace, sympify_equations

        ns = generate_sympify_namespace("x", self._dep_vars, self._help_funcs)
        return sympify_equations(self._diff_eqs, ns, self._dep_vars, self._help_funcs)
