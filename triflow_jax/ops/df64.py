"""Double-float (df64) arithmetic: ~1e-8-grade precision from f32 arithmetic.

The reference computes in float64 natively (SuperLU solves at
upstream triflow/core/schemes.py:148-163, ``double=True`` default at
upstream triflow/core/model.py:148); the BASELINE 1e-8 trajectory
target encodes that.  The measured f32 error envelope (~1e-5..1e-6) is
REPRESENTATION-bound: no compensation scheme on f32 values can close it.
A double-float attacks the representation itself: every value is an unevaluated pair ``hi + lo`` of
f32s with ``|lo| <= ulp(hi)/2``, giving ~49 bits of effective significand
(eps ~ 2^-48 ~ 3.6e-15) from pure f32 arithmetic.

Algorithms are the classical error-free transforms (Dekker 1971, Knuth TAoCP
v2, Hida-Li-Bailey QD library): TwoSum, Veltkamp splitting, TwoProd via
split products (each 12-bit half-product of two f32s is exact in f32).
Correct rounding of f32 add/mul is the only hardware assumption; XLA
performs no unsafe floating-point reassociation, so the transforms survive
jit.

Matrix units may not carry f32 semantics (reduced-precision passes) —
everything here is elementwise arithmetic; the df64 solver
(ops/banded_df.py) never emits a dot.

Transcendental functions are first-order corrected (``f(hi) + f'(hi)*lo``)
and therefore only f32-grade in their last bits; rational expressions —
every BASELINE workload — are fully df64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _f32(x):
    return jnp.asarray(x, jnp.float32)


# ---------------------------------------------------------------------------
# error-free transforms (building blocks)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """TwoSum under the precondition |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Split a == hi + lo into 12-bit-significand halves (exact).

    NOT the arithmetic Veltkamp split ``c = 4097*a; hi = c - (c - a)``:
    compiler FMA contraction (LLVM on the XLA CPU backend fuses the
    mul-sub into an fma with no intermediate rounding) silently breaks it
    under jit — measured 1-ulp hi corruption that cost the whole pipeline
    ~7 decimal digits.  Mantissa bit-masking computes the same truncated
    split and is immune to any floating-point rewrite: hi keeps the
    implicit bit + the top 11 explicit mantissa bits (12 significand
    bits), lo = a - hi is exact (same exponent, full cancellation) and
    also fits 12 bits — so every cross product of two splits is exact in
    f32 (24-bit significands).

    Rank-0 operands route through a (1, 1) view: the (1, 1) bitcast +
    reshape-back is value-identical to a scalar bitcast."""
    if getattr(a, "ndim", 0) == 0 and not isinstance(a, (float, np.floating)):
        v = jnp.reshape(a, (1, 1))
        vi = jax.lax.bitcast_convert_type(v, jnp.uint32)
        hi = jnp.reshape(
            jax.lax.bitcast_convert_type(vi & np.uint32(0xFFFFF000),
                                         jnp.float32), ())
        return hi, a - hi
    ai = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        ai & np.uint32(0xFFFFF000), jnp.float32
    )
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b (+O(eps^2 ab)) with |e| <= ulp(p)/2.

    COMPILER-REWRITE-IMMUNE BY CONSTRUCTION — this is not the classical
    Dekker product.  Dekker computes ``p = fl(a*b)`` and recovers the
    rounding error from split partial products; that breaks under FMA
    contraction (XLA:CPU lowers fusions through LLVM with ``contract``
    fast-math flags, so a consumer's ``p + x`` becomes ``fma(a, b, x)``
    with the UNROUNDED product — measured as a 7-decimal-digit loss; the
    barriers that would prevent it are stripped by the CPU pipeline).

    Here instead the product is assembled purely from EXACT partial
    products of the 12-bit mantissa-masked halves (each fits f32's 24-bit
    significand) combined with error-free additions: FMA-contracting an
    exact multiply into an add is value-identical, and adds never
    contract with adds — so no floating-point rewrite can change the
    result on any backend."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    t1 = a_hi * b_hi                     # all four partials are exact
    s1, r1 = two_sum(a_hi * b_lo, a_lo * b_hi)
    p, e1 = two_sum(t1, s1)
    e = e1 + (r1 + a_lo * b_lo)
    return quick_two_sum(p, e)


# ---------------------------------------------------------------------------
# (hi, lo) kernels
# ---------------------------------------------------------------------------

def add_(xh, xl, yh, yl):
    """Full double-double addition (2Sum-based, ~IEEE-style error)."""
    sh, se = two_sum(xh, yh)
    tl, te = two_sum(xl, yl)
    se = se + tl
    sh, se = quick_two_sum(sh, se)
    se = se + te
    return quick_two_sum(sh, se)


def add_f(xh, xl, y):
    """df64 + f32."""
    sh, se = two_sum(xh, y)
    se = se + xl
    return quick_two_sum(sh, se)


def mul_(xh, xl, yh, yl):
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return quick_two_sum(ph, pe)


def mul_f(xh, xl, y):
    ph, pe = two_prod(xh, y)
    pe = pe + xl * y
    return quick_two_sum(ph, pe)


def div_(xh, xl, yh, yl):
    q1 = xh / yh
    # r = x - q1 * y, computed in df64
    th, tl = mul_f(yh, yl, q1)
    rh, rl = add_(xh, xl, -th, -tl)
    q2 = rh / yh
    th, tl = mul_f(yh, yl, q2)
    rh, rl = add_(rh, rl, -th, -tl)
    q3 = rh / yh
    qh, ql = quick_two_sum(q1, q2)
    return add_f(qh, ql, q3)


def neg_(xh, xl):
    return -xh, -xl


def from_f64(x):
    """Split a host float64 array into an exact (hi, lo) f32 pair."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(hi, lo):
    hi = np.asarray(hi, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    return hi + lo


def from_scalar(c):
    """Exact df64 representation of a Python float constant."""
    c = float(c)
    hi = np.float32(c)
    lo = np.float32(c - float(hi))
    return hi, lo


# ---------------------------------------------------------------------------
# the DF array: an operator-overloaded (hi, lo) pytree
# ---------------------------------------------------------------------------

def _coerce(other):
    """Lift a scalar / plain array to a (hi, lo) pair; DF passes through."""
    if isinstance(other, DF):
        return other.hi, other.lo
    if isinstance(other, (int, float)):
        hi, lo = from_scalar(other)
        return _f32(hi), _f32(lo)
    arr = jnp.asarray(other)
    if arr.dtype == jnp.float64:  # x64-enabled hosts: exact split
        hi = arr.astype(jnp.float32)
        return hi, (arr - hi.astype(jnp.float64)).astype(jnp.float32)
    return _f32(arr), jnp.zeros_like(arr, dtype=jnp.float32)


@jax.tree_util.register_pytree_node_class
class DF:
    """Double-float array: value = hi + lo, both f32, |lo| <= ulp(hi)/2.

    Supports the operator surface that sympy.lambdify emits for rational
    expressions (+ - * / ** with integer powers) plus the structural
    operations the solver needs.  Registered as a pytree so it rides through
    jit / scan / while_loop / tree_map unchanged.
    """

    __array_priority__ = 1000  # beat numpy's ufunc dispatch in mixed ops

    def __init__(self, hi, lo=None):
        self.hi = _f32(hi)
        self.lo = (jnp.zeros_like(self.hi) if lo is None else _f32(lo))

    # pytree ---------------------------------------------------------------
    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = cls.__new__(cls)
        obj.hi, obj.lo = leaves
        return obj

    # constructors ---------------------------------------------------------
    @classmethod
    def from_float64(cls, x):
        hi, lo = from_f64(x)
        return cls(jnp.asarray(hi), jnp.asarray(lo))

    @classmethod
    def wrap(cls, hi, lo):
        obj = cls.__new__(cls)
        obj.hi, obj.lo = _f32(hi), _f32(lo)
        return obj

    def to_float64(self):
        return to_f64(np.asarray(self.hi), np.asarray(self.lo))

    # introspection --------------------------------------------------------
    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def dtype(self):  # the component dtype; effective precision is ~2x
        return self.hi.dtype

    def __repr__(self):
        return f"DF(hi={self.hi!r}, lo={self.lo!r})"

    # arithmetic -----------------------------------------------------------
    def __add__(self, other):
        oh, ol = _coerce(other)
        return DF.wrap(*add_(self.hi, self.lo, oh, ol))

    __radd__ = __add__

    def __sub__(self, other):
        oh, ol = _coerce(other)
        return DF.wrap(*add_(self.hi, self.lo, -oh, -ol))

    def __rsub__(self, other):
        oh, ol = _coerce(other)
        return DF.wrap(*add_(oh, ol, -self.hi, -self.lo))

    def __neg__(self):
        return DF.wrap(-self.hi, -self.lo)

    def __pos__(self):
        return self

    def __mul__(self, other):
        oh, ol = _coerce(other)
        return DF.wrap(*mul_(self.hi, self.lo, oh, ol))

    __rmul__ = __mul__

    def __truediv__(self, other):
        oh, ol = _coerce(other)
        return DF.wrap(*div_(self.hi, self.lo, oh, ol))

    def __rtruediv__(self, other):
        oh, ol = _coerce(other)
        return DF.wrap(*div_(oh, ol, self.hi, self.lo))

    def __pow__(self, n):
        if isinstance(n, DF):
            if n.lo.ndim == 0 and float(np.asarray(n.lo)) == 0.0:
                n = float(np.asarray(n.hi))
            else:  # pragma: no cover - df64 exponents unsupported
                raise TypeError("DF ** DF is not supported")
        if isinstance(n, float) and n == int(n):
            n = int(n)
        if not isinstance(n, (int, np.integer)):
            # rational powers: first-order corrected (f32-grade tail)
            if n == 0.5:
                return df_sqrt(self)
            v = self.hi ** np.float32(n)
            dv = np.float32(n) * self.hi ** np.float32(n - 1) * self.lo
            return DF.wrap(*quick_two_sum(v, dv))
        if n < 0:
            return (DF.wrap(*from_scalar(1.0)) / self) ** (-n)
        if n == 0:
            return DF.wrap(jnp.ones_like(self.hi), jnp.zeros_like(self.lo))
        # square-and-multiply in full df64
        result = None
        base = self
        m = int(n)
        while m:
            if m & 1:
                result = base if result is None else result * base
            m >>= 1
            if m:
                base = base * base
        return result

    # comparisons (on the combined value; hi dominates, lo breaks ties) ----
    def _cmp(self, other, op):
        oh, ol = _coerce(other)
        dh, dl = add_(self.hi, self.lo, -oh, -ol)
        zero = jnp.zeros_like(dh)
        return op(dh + dl, zero)

    def __lt__(self, other):
        return self._cmp(other, jnp.less)

    def __le__(self, other):
        return self._cmp(other, jnp.less_equal)

    def __gt__(self, other):
        return self._cmp(other, jnp.greater)

    def __ge__(self, other):
        return self._cmp(other, jnp.greater_equal)

    # structural -----------------------------------------------------------
    def __getitem__(self, idx):
        return DF.wrap(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return DF.wrap(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def astype_value(self):
        """Collapse to a plain f32 array (hi + lo rounds to hi)."""
        return self.hi + self.lo

    @property
    def at(self):
        return _DFAt(self)


class _DFAt:
    """``df.at[idx].set/add`` mirroring jnp's functional updates."""

    def __init__(self, df):
        self._df = df

    def __getitem__(self, idx):
        return _DFAtIdx(self._df, idx)


class _DFAtIdx:
    def __init__(self, df, idx):
        self._df, self._idx = df, idx

    def set(self, value):
        vh, vl = _coerce(value)
        idx = self._idx
        return DF.wrap(self._df.hi.at[idx].set(vh),
                       self._df.lo.at[idx].set(vl))

    def add(self, value):
        updated = self._df[self._idx] + value
        return self._df.at[self._idx].set(updated)


# ---------------------------------------------------------------------------
# structural helpers (exact: map over components)
# ---------------------------------------------------------------------------

def df_map(fn, *dfs):
    """Apply a structural (value-preserving) array op componentwise."""
    return DF.wrap(fn(*[d.hi for d in dfs]), fn(*[d.lo for d in dfs]))


def df_stack(dfs, axis=0):
    return DF.wrap(jnp.stack([d.hi for d in dfs], axis=axis),
                   jnp.stack([d.lo for d in dfs], axis=axis))


def df_concat(dfs, axis=0):
    return DF.wrap(jnp.concatenate([d.hi for d in dfs], axis=axis),
                   jnp.concatenate([d.lo for d in dfs], axis=axis))


def df_roll(df, shift, axis=-1):
    return df_map(lambda a: jnp.roll(a, shift, axis=axis), df)


def df_moveaxis(df, src, dst):
    return df_map(lambda a: jnp.moveaxis(a, src, dst), df)


def df_pad(df, pad_width, mode="constant"):
    return df_map(lambda a: jnp.pad(a, pad_width, mode=mode), df)


def df_zeros(shape):
    z = jnp.zeros(shape, jnp.float32)
    return DF.wrap(z, z)


def df_zeros_like(df):
    return df_map(jnp.zeros_like, df)


def df_where(pred, a, b):
    ah, al = _coerce(a)
    bh, bl = _coerce(b)
    return DF.wrap(jnp.where(pred, ah, bh), jnp.where(pred, al, bl))


def df_broadcast_to(df, shape):
    return df_map(lambda a: jnp.broadcast_to(a, shape), df)


def df_abs(df):
    neg = (df.hi + df.lo) < 0
    return df_where(neg, -df, df)


def df_maximum(a, b):
    a = a if isinstance(a, DF) else DF.wrap(*_coerce(a))
    b = b if isinstance(b, DF) else DF.wrap(*_coerce(b))
    return df_where((a.hi + a.lo) >= (b.hi + b.lo), a, b)


def df_minimum(a, b):
    a = a if isinstance(a, DF) else DF.wrap(*_coerce(a))
    b = b if isinstance(b, DF) else DF.wrap(*_coerce(b))
    return df_where((a.hi + a.lo) <= (b.hi + b.lo), a, b)


def df_max_abs(df):
    """max|value| as a plain f32 scalar (error-estimate reductions)."""
    return jnp.max(jnp.abs(df.hi + df.lo))


def host64(a):
    """Host float64 numpy view of a DF pair or plain array — the one
    conversion point persistence/checkpoint layers use, so DF state round
    trips exactly (hi + lo is exactly representable in f64, and
    DF.from_float64 of that value reproduces the identical pair)."""
    return a.to_float64() if isinstance(a, DF) else np.asarray(a)


def df_sqrt(df):
    """df64 sqrt via one Newton step on the f32 estimate (full df64)."""
    y0 = jnp.sqrt(df.hi)
    # y = y0 + (x - y0^2) / (2 y0), the correction computed in df64
    y0df = DF(y0)
    r = df - y0df * y0df
    corr = r / DF(2.0 * y0)
    return y0df + corr


def _lifted(fname, d_fname):
    """First-order corrected transcendental: f(hi) + f'(hi)*lo (f32-grade
    in the last bits — documented limitation; BASELINE workloads are
    rational)."""
    f = getattr(jnp, fname)
    df_ = d_fname

    def wrapped(x):
        if not isinstance(x, DF):
            return f(x)
        v = f(x.hi)
        dv = df_(x.hi) * x.lo
        return DF.wrap(*quick_two_sum(v, dv))

    return wrapped


def _df_heaviside(x, *h0):
    xv = x.hi + x.lo if isinstance(x, DF) else x
    h = h0[0] if h0 else 0.5
    h = h.astype_value() if isinstance(h, DF) else h
    return DF(jnp.heaviside(xv, jnp.asarray(h, jnp.float32)))


def _df_max(*args):
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        args = args[0]
    out = args[0] if isinstance(args[0], DF) else DF.wrap(*_coerce(args[0]))
    for a in args[1:]:
        out = df_maximum(out, a)
    return out


def _df_min(*args):
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        args = args[0]
    out = args[0] if isinstance(args[0], DF) else DF.wrap(*_coerce(args[0]))
    for a in args[1:]:
        out = df_minimum(out, a)
    return out


def _df_abs_fn(x):
    return df_abs(x) if isinstance(x, DF) else jnp.abs(x)


def _df_sqrt_fn(x):
    return df_sqrt(x) if isinstance(x, DF) else jnp.sqrt(x)


#: lambdify module dict for evaluating sympy expressions on DF arrays
LAMBDIFY_MODULES = [
    {
        "Max": _df_max, "Min": _df_min, "amax": _df_max, "amin": _df_min,
        "Heaviside": _df_heaviside,
        "Abs": _df_abs_fn, "abs": _df_abs_fn, "fabs": _df_abs_fn,
        "sqrt": _df_sqrt_fn,
        "sign": lambda x: DF(jnp.sign(x.hi + x.lo)) if isinstance(x, DF)
        else jnp.sign(x),
        "exp": _lifted("exp", lambda h: jnp.exp(h)),
        "log": _lifted("log", lambda h: 1.0 / h),
        "sin": _lifted("sin", jnp.cos),
        "cos": _lifted("cos", lambda h: -jnp.sin(h)),
        "tan": _lifted("tan", lambda h: 1.0 / jnp.cos(h) ** 2),
        "tanh": _lifted("tanh", lambda h: 1.0 - jnp.tanh(h) ** 2),
        "sinh": _lifted("sinh", jnp.cosh),
        "cosh": _lifted("cosh", jnp.sinh),
    },
    "jax",
]
