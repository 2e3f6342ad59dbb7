"""Symbolic front-end: equation parsing and finite-difference discretization.

This is the pure-Python (SymPy) layer of the framework: it turns math strings
such as ``"k * dxxU - c * dxU"`` into discretized right-hand-side expressions
``F_m`` written over *offset symbols* (``U_m1``, ``U``, ``U_p1``, ...) and into
a **structurally banded Jacobian** ``J[m, n, k] = dF_m / d(var_n at offset k)``.

Behavioral parity with the reference implementation
(upstream ``triflow/core/model.py:25-74`` for the sympify namespace,
``model.py:401-478`` for the stencil library and ``model.py:544-577`` for the
derivative substitution), but the Jacobian is organized **banded by
construction** — offsets are first-class — instead of being flattened into a
CSC assembly, because the banded layout maps directly onto dense
device arrays and the banded solver (ops/banded.py).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import partial
from itertools import product
from typing import Dict, Tuple

import sympy as sp
from sympy import (
    Derivative,
    Function,
    Max,
    Min,
    Symbol,
    SympifyError,
    sympify,
)

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())

#: forward-difference epsilon used when ``fdiff_jac`` is requested
#: (reference: upstream triflow/core/model.py:22)
EPS = 1e-6

#: maximum spatial-derivative order exposed without opting in to high-order
#: stencils.  The reference raises NotImplementedError above order 4
#: (upstream triflow/core/model.py:437-439); we keep that contract by
#: default and unlock arbitrary orders behind ``high_order=True``.
DEFAULT_MAX_ORDER = 4


def offset_symbol(var: str, offset: int) -> Symbol:
    """Symbol naming convention for a discrete unknown at a stencil offset.

    ``offset_symbol("U", -2) -> U_m2``, ``offset_symbol("U", 0) -> U``,
    ``offset_symbol("U", 1) -> U_p1`` (reference naming:
    upstream triflow/core/model.py:388-399).
    """
    if offset == 0:
        return Symbol(var)
    tag = "m" if offset < 0 else "p"
    return Symbol(f"{var}_{tag}{abs(offset)}")


def generate_sympify_namespace(independent_variable, dependent_variables, helper_functions):
    """Namespace mapping derivative tokens to SymPy objects.

    Supports both the token form (``dxxU``) and the functional form
    (``dxx(U)``, ``dx(U, 2)``) for derivative orders 1-9, mirroring
    upstream triflow/core/model.py:25-74.
    """
    x = Symbol(independent_variable)

    def partial_derivative(order, expr, n=None):
        # ``dx(U)`` / ``dxx(U)`` use the token's order; ``dx(U, n)`` names
        # the order explicitly (n wins over the token form)
        return Derivative(expr, x, int(n) if n is not None else order)

    namespace = {independent_variable: x}
    namespace.update(
        {
            "d" + independent_variable * order: partial(partial_derivative, order)
            for order in range(1, 10)
        }
    )
    namespace.update(
        {
            f"d{independent_variable * order}{var}": Derivative(Function(var)(x), x, order)
            for order, var in product(
                range(1, 10), tuple(dependent_variables) + tuple(helper_functions)
            )
        }
    )
    return namespace


def centered_stencil_coefficients(order: int, half_width: int) -> Dict[int, sp.Rational]:
    """Centered finite-difference weights for d^order/dx^order on the uniform
    grid offsets ``-half_width .. +half_width`` (2nd-order accurate minimal
    stencils for ``half_width == ceil(order / 2) + (order > 2 and order odd)``).

    For orders 1-4 these reproduce the hand-written stencils of the reference
    (upstream triflow/core/model.py:401-439):
      order 1: (-1/2, 0, 1/2) / dx
      order 2: (1, -2, 1) / dx**2
      order 3: (-1/2, 1, 0, -1, 1/2) / dx**3
      order 4: (1, -4, 6, -4, 1) / dx**4
    Higher orders are generated from sympy.finite_diff_weights.
    """
    offsets = list(range(-half_width, half_width + 1))
    weights = sp.finite_diff_weights(order, offsets, 0)[order][-1]
    return {off: w for off, w in zip(offsets, weights) if w != 0}


def stencil_half_width(order: int) -> int:
    """Minimal symmetric half-width for a 2nd-order accurate centered stencil.

    order 1, 2 -> 1; order 3, 4 -> 2; order 5, 6 -> 3; ...
    """
    return (order + 1) // 2 if order % 2 else order // 2


@dataclass
class StencilTracker:
    """Tracks, per variable, which stencil offsets appear after discretization
    (the reference keeps this in ``_symb_vars_with_spatial_diff_order``,
    upstream triflow/core/model.py:219-224)."""

    offsets: Dict[str, set] = field(default_factory=dict)

    def touch(self, var: str, offset: int) -> Symbol:
        self.offsets.setdefault(var, {0}).add(offset)
        return offset_symbol(var, offset)

    def bounds(self, variables) -> Tuple[int, int]:
        lo, hi = 0, 0
        for var in variables:
            offs = self.offsets.get(var, {0})
            lo = min(lo, min(offs))
            hi = max(hi, max(offs))
        return lo, hi


def finite_difference(tracker: StencilTracker, var: Symbol, order: int,
                      high_order: bool = False) -> sp.Expr:
    """Replace d^order(var)/dx^order by its centered FD approximation written
    over offset symbols.  Parity: upstream triflow/core/model.py:401-439."""
    if order == 0:
        return var
    if order > DEFAULT_MAX_ORDER and not high_order:
        raise NotImplementedError(
            "Finite difference up to 5th order not implemented yet "
            "(pass high_order=True to enable arbitrary-order stencils)"
        )
    name = str(var)
    dx = Symbol("dx")
    coeffs = centered_stencil_coefficients(order, stencil_half_width(order))
    return sum(w * tracker.touch(name, off) for off, w in coeffs.items()) / dx ** order


def upwind(tracker: StencilTracker, velocity: sp.Expr, var: Symbol, accuracy=1,
           **_ignored) -> sp.Expr:
    """Upwind advection scheme ``upwind(vel, U, accuracy)`` with Max/Min flux
    splitting, accuracy 1-3 (parity: upstream triflow/core/model.py:441-478)."""
    accuracy = int(accuracy)
    dx = Symbol("dx")
    name = str(var)
    ap = Max(velocity, 0)
    am = Min(velocity, 0)
    t = partial(tracker.touch, name)
    U = Symbol(name)
    if accuracy == 1:
        backward = (U - t(-1)) / dx
        forward = (t(1) - U) / dx
    elif accuracy == 2:
        backward = (3 * U - 4 * t(-1) + t(-2)) / (2 * dx)
        forward = (-3 * U + 4 * t(1) - t(2)) / (2 * dx)
    elif accuracy == 3:
        backward = (2 * t(1) + 3 * U - 6 * t(-1) + t(-2)) / (6 * dx)
        forward = (-2 * t(-1) - 3 * U + 6 * t(1) - t(2)) / (6 * dx)
    else:
        raise NotImplementedError("Upwind accuracy up to 3rd order only")
    return ap * backward + am * forward


def sympify_equations(equations, namespace, dep_vars, help_funcs, indep_var="x"):
    """Parse equation strings into SymPy expressions with Derivative nodes.

    Raises ValueError on malformed input (parity with
    upstream triflow/core/model.py:511-525)."""
    x = Symbol(indep_var)
    symbolic_vars = {Symbol(v): Function(v)(x) for v in tuple(dep_vars) + tuple(help_funcs)}
    parsed = []
    try:
        for eq in equations:
            expr = sympify(eq, locals=dict(namespace))
            expr = expr.xreplace(symbolic_vars).doit()
            parsed.append(expr)
    except (TypeError, AttributeError, SympifyError, ValueError) as err:
        raise ValueError("badly formated differential equations") from err
    return tuple(parsed)


def discretize(equations, tracker: StencilTracker, dep_vars, help_funcs,
               indep_var="x", high_order=False):
    """Substitute every Derivative with its FD stencil and lower functions of
    x back to plain symbols (parity: upstream triflow/core/model.py:544-577)."""
    x = Symbol(indep_var)
    out = []
    for eq in equations:
        approx = eq
        for derivative in eq.find(Derivative):
            var = Symbol(str(derivative.args[0].func))
            order = 0
            for wrt in derivative.args[1:]:
                if isinstance(wrt, Symbol):
                    order += 1 if wrt == x else 0
                else:
                    if wrt[0] == x:
                        order += int(wrt[1])
            approx = approx.replace(
                derivative, finite_difference(tracker, var, order, high_order=high_order)
            )
        approx = approx.subs(
            [(Function(v)(x), Symbol(v)) for v in tuple(dep_vars) + tuple(help_funcs)]
        )
        approx = approx.replace(Function("upwind"), partial(upwind, tracker))
        out.append(approx.expand())
    return tuple(out)


@dataclass(frozen=True)
class DiscreteSystem:
    """The fully discretized 1D PDE system.

    Attributes
    ----------
    dep_vars, help_funcs, pars : tuple of str
    F_exprs : tuple of sympy.Expr
        RHS of each evolution equation over offset symbols.
    halo : int
        ghost-zone half width (max |offset|); the reference calls
        ``(window_range - 1) // 2`` the "middle point"
        (upstream triflow/core/compilers.py:59).
    bounds : (int, int)
        (-halo, +halo) — kept for reference parity
        (upstream triflow/core/model.py:380-386).
    J_band_exprs : dict[(m, n, k)] -> sympy.Expr
        dF_m/d(dep_var_n at offset k-halo); structural zeros are *omitted*.
    """

    dep_vars: Tuple[str, ...]
    help_funcs: Tuple[str, ...]
    pars: Tuple[str, ...]
    F_exprs: Tuple[sp.Expr, ...]
    bounds: Tuple[int, int]
    J_band_exprs: Dict[Tuple[int, int, int], sp.Expr]

    @property
    def nvar(self) -> int:
        return len(self.dep_vars)

    @property
    def halo(self) -> int:
        return max(-self.bounds[0], self.bounds[1])

    @property
    def window(self) -> int:
        return self.bounds[1] - self.bounds[0] + 1

    def unknown_symbols(self, variables=None) -> list:
        """Discrete unknown symbols ordered like the reference's flatten('F')
        ordering: offset-major, variable-minor
        (upstream triflow/core/model.py:249-262)."""
        variables = self.dep_vars if variables is None else variables
        lo, hi = self.bounds
        return [
            offset_symbol(var, off)
            for off in range(lo, hi + 1)
            for var in variables
        ]


def build_discrete_system(equations, dep_vars, pars, help_funcs,
                          simplify=False, fdiff_jac=False, high_order=False,
                          indep_var="x"):
    """Full symbolic pipeline: parse -> discretize -> banded Jacobian.

    Mirrors the orchestration of Model.__init__
    (upstream triflow/core/model.py:193-291) while emitting the
    Jacobian directly in banded (m, n, offset) coordinates.
    """
    namespace = generate_sympify_namespace(indep_var, dep_vars, help_funcs)
    symbolic_eqs = sympify_equations(equations, namespace, dep_vars, help_funcs, indep_var)

    tracker = StencilTracker({v: {0} for v in tuple(dep_vars) + tuple(help_funcs)})
    F_exprs = discretize(symbolic_eqs, tracker, dep_vars, help_funcs, indep_var,
                         high_order=high_order)

    # ghost width over every discretized variable (deps *and* helpers: the
    # reference computes bounds over deps only, model.py:244-247, which would
    # break for helper-only high derivatives — we implement the intent).
    lo, hi = tracker.bounds(tuple(dep_vars) + tuple(help_funcs))
    # symmetrize: a banded layout with equal left/right halo keeps every
    # downstream kernel (padding, halo exchange, solver supernodes) uniform;
    # asymmetric stencils only add structural-zero bands.
    halo = max(-lo, hi)
    bounds = (-halo, halo)
    lo, hi = bounds

    if simplify:
        F_exprs = tuple(eq.simplify() for eq in F_exprs)

    # reject stray symbols (typos like "dxxxxxxxxxxU" beyond the order-9
    # token namespace, or undeclared parameters): the reference surfaces
    # these as compile-time failures when lambdify hits an unbound input;
    # we fail fast with a clear message instead.
    import re as _re

    discretized_vars = set(dep_vars) | set(help_funcs)
    known_names = discretized_vars | set(pars)
    offset_pat = _re.compile(r"^(.+)_(?:m|p)\d+$")
    stray = set()
    for eq in F_exprs:
        for sym in eq.free_symbols:
            name = str(sym)
            if name in known_names or name in (indep_var, "dx"):
                continue
            mo = offset_pat.match(name)
            if mo and mo.group(1) in discretized_vars:
                continue
            stray.add(name)
    if stray:
        raise ValueError(
            "unknown symbol(s) %s in the differential equations: not a "
            "dependent variable, parameter, helper function or derivative "
            "token (dx...%s, orders 1-9)" % (sorted(stray), indep_var)
        )

    J_band_exprs = {}
    for m, eq in enumerate(F_exprs):
        for off in range(lo, hi + 1):
            for n, var in enumerate(dep_vars):
                u = offset_symbol(var, off)
                if fdiff_jac:
                    entry = (eq.subs(u, u + EPS) - eq) / EPS
                else:
                    entry = eq.diff(u)
                if simplify and entry != 0:
                    entry = entry.expand().simplify()
                if entry != 0:
                    J_band_exprs[(m, n, off - lo)] = entry

    return DiscreteSystem(
        dep_vars=tuple(dep_vars),
        help_funcs=tuple(help_funcs),
        pars=tuple(pars),
        F_exprs=tuple(F_exprs),
        bounds=bounds,
        J_band_exprs=J_band_exprs,
    )
