"""df64 (double-float) block-banded solver: the precision twin of
ops/banded.py.

Same algorithm family — supernode block-tridiagonal assembly, chunked
Thomas/SPIKE sweeps with a PCR-factored reduced interface system, PCR for
small M, Sherman-Morrison-Woodbury periodic corners — but every arithmetic
operation runs in double-float (hi, lo) pairs (ops/df64.py), giving ~49-bit
significands from f32 ops — an alternative to the reference's float64
SuperLU solves (upstream triflow/core/schemes.py:148-163) at
~10-30x the f32 op count.

No dots anywhere: block products are unrolled elementwise multiply-adds
(a reduced-precision matrix-unit pass would destroy the error-free
transforms).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .banded import _wrapped_indices
from .df64 import (
    DF,
    df_concat,
    df_map,
    df_roll,
    df_stack,
    df_where,
    df_zeros,
    df_zeros_like,
)


# ---------------------------------------------------------------------------
# block algebra on DF stacks (..., s, s, M) / (..., s, M)
# ---------------------------------------------------------------------------

def _stack_block(rows):
    return df_stack([df_stack(r, axis=-2) for r in rows], axis=-3)


def _mm(a, b):
    """(..., m, k, M) @ (..., k, n, M) with ARRAY-level DF ops: one DF
    multiply over the broadcast (m, k, n, M) product and k-1 DF adds over
    the contraction axis — ~15x fewer HLO ops than per-element slicing,
    with identical arithmetic (same ascending-q summation order)."""
    k = a.shape[-2]
    aa = a[..., :, :, None, :]      # (..., m, k, 1, M)
    bb = b[..., None, :, :, :]      # (..., 1, k, n, M)
    prod = aa * bb                  # (..., m, k, n, M)
    acc = prod[..., :, 0, :, :]
    for q in range(1, k):
        acc = acc + prod[..., :, q, :, :]
    return acc


def _mv(a, b):
    """(..., m, k, M) @ (..., k, M) -> (..., m, M), array-level DF ops."""
    k = a.shape[-2]
    prod = a * b[..., None, :, :]   # (..., m, k, M)
    acc = prod[..., :, 0, :]
    for q in range(1, k):
        acc = acc + prod[..., :, q, :]
    return acc


def _small_inv(D):
    s = D.shape[-3]
    if s == 1:
        return _inv1(D)
    if s == 2:
        a = D[..., 0, 0, :]
        b = D[..., 0, 1, :]
        c = D[..., 1, 0, :]
        d = D[..., 1, 1, :]
        inv_det = 1.0 / (a * d - b * c)
        return _stack_block(
            [[d * inv_det, -b * inv_det], [-c * inv_det, a * inv_det]]
        )
    # block-Schur recursion (mirrors banded._small_inv)
    p = s // 2
    A = D[..., :p, :p, :]
    B = D[..., :p, p:, :]
    C = D[..., p:, :p, :]
    Dd = D[..., p:, p:, :]
    Ainv = _small_inv(A)
    Sinv = _small_inv(Dd - _mm(C, _mm(Ainv, B)))
    AinvB = _mm(Ainv, B)
    CAinv = _mm(C, Ainv)
    top_left = Ainv + _mm(AinvB, _mm(Sinv, CAinv))
    top_right = -_mm(AinvB, Sinv)
    bot_left = -_mm(Sinv, CAinv)
    top = df_concat([top_left, top_right], axis=-2)
    bot = df_concat([bot_left, Sinv], axis=-2)
    return df_concat([top, bot], axis=-3)


def _inv1(D):
    return _stack_block([[1.0 / D[..., 0, 0, :]]])


# ---------------------------------------------------------------------------
# wrap extraction + supernode assembly (structural, mirrors banded.py)
# ---------------------------------------------------------------------------

def _extract_wrap(bands, periodic: bool):
    W, nvar, _, N = bands.shape[-4:]
    h = W // 2
    if not periodic or h == 0:
        return bands, None, None
    P = nvar * h
    batch = bands.shape[:-4]
    T = df_zeros(batch + (P, P))
    B = df_zeros(batch + (P, P))
    top, bottom = _wrapped_indices(W, nvar, N)
    for (k, i, r, c) in top:
        T = T.at[..., r * nvar:(r + 1) * nvar,
                 c * nvar:(c + 1) * nvar].set(bands[..., k, :, :, i])
        bands = bands.at[..., k, :, :, i].set(0.0)
    for (k, i, r, c) in bottom:
        B = B.at[..., r * nvar:(r + 1) * nvar,
                 c * nvar:(c + 1) * nvar].set(bands[..., k, :, :, i])
        bands = bands.at[..., k, :, :, i].set(0.0)
    return bands, T, B


def _assemble_blocks(bands, keep_ring=False):
    """Supernode block-tridiagonal (L, D, U) from the bands.  With
    ``keep_ring=True`` (periodic, N divisible by g) the wrap entries of
    the boundary supernodes are KEPT as L[0] / U[M-1] ring couplings —
    the block-Toeplitz structure maps column (i+delta) mod N to exactly
    the right local position of the opposite supernode — so the periodic
    closure rides the chunk-interface ring (cyclic PCR) with no Woodbury
    correction at all."""
    W, nvar, _, N = bands.shape[-4:]
    h = W // 2
    g = max(h, 1)
    s = nvar * g
    M = -(-N // g)
    Np = M * g
    batch = bands.shape[:-4]
    if Np != N:
        pad_width = [(0, 0)] * (bands.ndim - 1) + [(0, Np - N)]
        bands = df_map(lambda a: jnp.pad(a, pad_width), bands)
        diag_idx = jnp.arange(nvar)
        bands = DF.wrap(
            bands.hi.at[..., h, diag_idx, diag_idx, N:].set(1.0),
            bands.lo.at[..., h, diag_idx, diag_idx, N:].set(0.0),
        )

    bands_t = df_map(
        lambda a: jnp.moveaxis(a.reshape(batch + (W, nvar, nvar, M, g)),
                               -1, -5),
        bands,
    )
    bands_t = DF.wrap(*jax.lax.optimization_barrier((bands_t.hi, bands_t.lo)))
    zero = df_zeros(batch + (M,))

    def block(dblock):
        rows = []
        for a in range(g):
            for m in range(nvar):
                row = []
                for b in range(g):
                    for n in range(nvar):
                        delta = (b - a) + dblock
                        if abs(delta) > h:
                            row.append(zero)
                        else:
                            row.append(bands_t[..., a, h + delta, m, n, :])
                rows.append(df_stack(row, axis=-2))
        return df_stack(rows, axis=-3)

    L = block(-g)
    D = block(0)
    U = block(g)
    if not keep_ring:
        L = L.at[..., 0].set(0.0)
        U = U.at[..., M - 1].set(0.0)
    return L, D, U, g, s, M, Np


# ---------------------------------------------------------------------------
# PCR (small M)
# ---------------------------------------------------------------------------

class PcrFactorDF:
    def __init__(self, alphas, betas, Dinv, ds):
        self.alphas, self.betas, self.Dinv, self.ds = alphas, betas, Dinv, tuple(ds)


jax.tree_util.register_pytree_node(
    PcrFactorDF,
    lambda f: ((f.alphas, f.betas, f.Dinv), f.ds),
    lambda ds, leaves: PcrFactorDF(*leaves, ds),
)


def _pcr_factor(L, D, U, cyclic=False):
    """Unrolled PCR levels; ``cyclic=True`` (power-of-two M) keeps the
    ring couplings — rolls wrap naturally and the leftover distance-M
    couplings ARE the diagonal, absorbed into the final block inverse
    (same construction as banded._pcr_factor_xla)."""
    M = L.shape[-1]
    if cyclic and M & (M - 1):
        raise ValueError("cyclic PCR requires power-of-two M")
    idx = jnp.arange(M)
    levels = []
    d = 1
    while d < M:
        Dinv = _small_inv(D)
        alpha = -_mm(L, df_roll(Dinv, d))
        beta = -_mm(U, df_roll(Dinv, -d))
        if not cyclic:
            alpha = df_where(idx >= d, alpha, 0.0)
            beta = df_where(idx < M - d, beta, 0.0)
        newD = D + _mm(alpha, df_roll(U, d)) + _mm(beta, df_roll(L, -d))
        newL = _mm(alpha, df_roll(L, d))
        newU = _mm(beta, df_roll(U, -d))
        levels.append((alpha, beta, d))
        L, D, U = newL, newD, newU
        d *= 2
    if cyclic:
        D = D + L + U
    return PcrFactorDF([a for a, _, _ in levels], [b for _, b, _ in levels],
                       _small_inv(D), [d for _, _, d in levels])


def _pcr_solve(fact, b):
    for alpha, beta, d in zip(fact.alphas, fact.betas, fact.ds):
        b = b + _mv(alpha, df_roll(b, d)) + _mv(beta, df_roll(b, -d))
    return _mv(fact.Dinv, b)


# ---------------------------------------------------------------------------
# chunked Thomas / SPIKE (large M)
# ---------------------------------------------------------------------------

class ChunkedFactorDF:
    def __init__(self, fac, Dhinv, DU, W, V, red, C, Mc, M, s,
                 cyclic=False):
        self.fac, self.Dhinv, self.DU = fac, Dhinv, DU
        self.W, self.V, self.red = W, V, red
        self.C, self.Mc, self.M, self.s = C, Mc, M, s
        self.cyclic = cyclic


jax.tree_util.register_pytree_node(
    ChunkedFactorDF,
    lambda f: ((f.fac, f.Dhinv, f.DU, f.W, f.V, f.red),
               (f.C, f.Mc, f.M, f.s, f.cyclic)),
    lambda aux, leaves: ChunkedFactorDF(*leaves, *aux),
)


class RingReducedDF:
    """Reduced chunk-interface RING (periodic, any C): acyclic PCR of the
    peeled chain + a rank-2s Woodbury correction — the df64 twin of
    parallel/spatial._InterfaceWoodbury, here applied at the WITHIN-chip
    chunk level so the periodic closure never needs full-size spike
    columns (the former Woodbury attach cost ~4 full tri-solves per
    factorization — ~40% of the df64 step at N=1e6)."""

    def __init__(self, fact, Z, cap_inv, s, C):
        self.fact, self.Z, self.cap_inv = fact, Z, cap_inv
        self.s, self.C = s, C

    def solve(self, yred):
        s, C = self.s, self.C
        y = _pcr_solve(self.fact, yred)                # (..., 2s, C)
        vty = df_concat([y[..., s:, C - 1], y[..., :s, 0]], axis=-1)
        coef = _dense_matvec(self.cap_inv, vty)        # (..., 2s)
        corr = self.Z[..., 0, :, :] * coef[..., 0, None, None]
        for c in range(1, 2 * s):
            corr = corr + self.Z[..., c, :, :] * coef[..., c, None, None]
        return y - corr


jax.tree_util.register_pytree_node(
    RingReducedDF,
    lambda f: ((f.fact, f.Z, f.cap_inv), (f.s, f.C)),
    lambda aux, leaves: RingReducedDF(*leaves, *aux),
)


def _to_chunks(A, C, Mc):
    return df_map(
        lambda a: jnp.moveaxis(a.reshape(a.shape[:-1] + (C, Mc)), -1, 0), A
    )


def _from_chunks(A, M):
    def f(a):
        a = jnp.moveaxis(a, 0, -1)
        a = a.reshape(a.shape[:-2] + (-1,))
        return a[..., :M]

    return df_map(f, A)


# df64 routes to the scan-based chunked path at almost every size: each
# unrolled PCR level costs ~20x the HLO of its f32 twin (every scalar op is
# an error-free-transform chain), and XLA compile time on the resulting
# 25k-op modules is pathological.  The lax.scan sweeps keep the traced
# graph at one-body size; the reduced interface PCR only ever sees C <= 8192
# supernodes and stays shallow.
_CHUNK_MIN_M = 16

def _pick_chunks(M: int) -> int:
    C = 1
    while C * 64 < M and C < 8192:
        C *= 2
    return C


def _pick_chunks_divisor(M: int, target_depth: int = 32):
    """Divisor C of M with sweep depth Mc = M/C nearest target_depth
    (the ring-native cyclic path needs C | M so no identity padding
    breaks the ring).  None when no divisor gives 2 <= Mc and C >= 8."""
    best = None
    d = 1
    while d * d <= M:
        if M % d == 0:
            for C in (d, M // d):
                Mc = M // C
                if Mc < 2 or C < 8 or C > 65536:
                    continue
                key = abs(Mc - target_depth)
                if best is None or key < best[0]:
                    best = (key, C)
        d += 1
    return None if best is None else best[1]


def _chunked_factor(L, D, U, C, cyclic=False):
    s, M = L.shape[-3], L.shape[-1]
    Mc = -(-M // C)
    Mp = Mc * C
    if cyclic and Mp != M:
        raise ValueError("cyclic chunked factor requires C | M")
    if Mp != M:
        padn = Mp - M
        eye = jnp.broadcast_to(jnp.eye(s, dtype=jnp.float32)[..., None],
                               D.shape[:-1] + (padn,))
        zero = jnp.zeros(L.shape[:-1] + (padn,), dtype=jnp.float32)
        L = df_map(lambda a, z=zero: jnp.concatenate([a, z], axis=-1), L)
        D = DF.wrap(jnp.concatenate([D.hi, eye], axis=-1),
                    jnp.concatenate([D.lo, jnp.zeros_like(eye)], axis=-1))
        U = df_map(lambda a, z=zero: jnp.concatenate([a, z], axis=-1), U)
    Lc = _to_chunks(L, C, Mc)
    Dc = _to_chunks(D, C, Mc)
    Uc = _to_chunks(U, C, Mc)
    Tl = Lc[0]
    Tr = Uc[-1]
    Lc = Lc.at[0].set(0.0)
    Uc = Uc.at[-1].set(0.0)

    zero_blk = df_zeros_like(Tl)
    bW = df_zeros_like(Lc).at[0].set(Tl)
    bV = df_zeros_like(Uc).at[-1].set(Tr)

    def fwd(carry, inputs):
        Dhinv_prev, U_prev, wt_prev = carry
        L_j, D_j, U_j, bW_j = inputs
        fac_j = _mm(L_j, Dhinv_prev)
        Dhinv_j = _small_inv(D_j - _mm(fac_j, U_prev))
        wt_j = bW_j - _mm(fac_j, wt_prev)
        return (Dhinv_j, U_j, wt_j), (fac_j, Dhinv_j, wt_j)

    init = (zero_blk, zero_blk, zero_blk)
    _, (fac, Dhinv, wt) = jax.lax.scan(fwd, init, (Lc, Dc, Uc, bW))

    def bwd(carry, inputs):
        W_next, V_next = carry
        Dhinv_j, U_j, wt_j, bV_j = inputs
        DhU = _mm(Dhinv_j, U_j)
        W_j = _mm(Dhinv_j, wt_j) - _mm(DhU, W_next)
        V_j = _mm(Dhinv_j, bV_j) - _mm(DhU, V_next)
        return (W_j, V_j), (W_j, V_j)

    _, (Wsp, Vsp) = jax.lax.scan(bwd, (zero_blk, zero_blk),
                                 (Dhinv, Uc, wt, bV), reverse=True)
    DU = _mm(Dhinv, Uc)

    # C == 1: no cross-chunk couplings exist (Tl/Tr are the structural
    # zeros of a non-cyclic system) — the interface solve is the identity;
    # building it anyway would bottom every recursion in a fat unrolled
    # 2s x 2s block inverse
    red = (_reduced_interface_factor(Wsp, Vsp, C, s, cyclic)
           if C > 1 else None)
    return ChunkedFactorDF(fac, Dhinv, DU, Wsp, Vsp, red, C, Mc, M, s,
                           cyclic=cyclic)


def _reduced_interface_factor(W, V, C, s, cyclic=False):
    d2 = 2 * s
    Lred = df_zeros(W.shape[1:-3] + (d2, d2, C))
    Ured = df_zeros_like(Lred)
    eye = jnp.broadcast_to(jnp.eye(d2, dtype=jnp.float32)[..., None],
                           Lred.hi.shape)
    Dred = DF.wrap(eye, jnp.zeros_like(eye))
    Lred = Lred.at[..., :s, s:, :].set(W[0])
    Lred = Lred.at[..., s:, s:, :].set(W[-1])
    Ured = Ured.at[..., :s, :s, :].set(V[0])
    Ured = Ured.at[..., s:, :s, :].set(V[-1])
    if cyclic:
        if C & (C - 1) == 0:
            # power-of-two ring: cyclic PCR, no correction at all
            return _pcr_factor(Lred, Dred, Ured, cyclic=True)
        # peel the two ring-wrap blocks (rank s each), factor the acyclic
        # chain, reinstate via a rank-2s Woodbury on the REDUCED system
        Lw = df_concat([W[0], W[-1]], axis=-3)      # (..., 2s, s, C) slice 0
        Vw = df_concat([V[0], V[-1]], axis=-3)      # (..., 2s, s, C) slice -1
        Lw0 = Lw[..., :, :, 0]                      # (..., 2s, s)
        VwC = Vw[..., :, :, C - 1]
        Lred = Lred.at[..., 0].set(0.0)
        Ured = Ured.at[..., C - 1].set(0.0)
        fact = _pcr_factor(Lred, Dred, Ured)
        cols = df_zeros(Lred.shape[:-3] + (d2, d2, C))
        cols = cols.at[..., :s, :, 0].set(
            df_map(lambda a: jnp.swapaxes(a, -1, -2), Lw0))
        cols = cols.at[..., s:, :, C - 1].set(
            df_map(lambda a: jnp.swapaxes(a, -1, -2), VwC))
        Z = _pcr_solve(fact, cols)                  # (..., 2s, d2, C)
        VtZ = df_concat([Z[..., :, s:, C - 1], Z[..., :, :s, 0]],
                        axis=-1)                    # (..., 2s, 2s) [c, r]
        cap = df_map(lambda a: jnp.swapaxes(a, -1, -2), VtZ)
        eye2 = jnp.eye(d2, dtype=jnp.float32)
        cap = DF.wrap(cap.hi + eye2, cap.lo)
        return RingReducedDF(fact, Z, _dense_inv(cap), s, C)
    Lred = Lred.at[..., 0].set(0.0)
    Ured = Ured.at[..., C - 1].set(0.0)
    # UNROLLED PCR for the interface system: log2(C) wide vectorized
    # levels with NO sequential loops.  Recursing through the scan-based
    # chunked path instead costs hundreds of tiny while-iterations per
    # solve (the dominant term of the 157 ms/step first cut at N=1e6 —
    # per-iteration overhead, not compute); with the array-level _mm the
    # unrolled levels stay ~2k HLO ops each.
    return _pcr_factor(Lred, Dred, Ured)


def _chunked_solve(fact, b):
    C, Mc, M, s = fact.C, fact.Mc, fact.M, fact.s
    Mp = Mc * C
    if Mp != M:
        pad = [(0, 0)] * (b.ndim - 1) + [(0, Mp - M)]
        b = df_map(lambda a: jnp.pad(a, pad), b)
    bc = df_map(
        lambda a: jnp.moveaxis(a.reshape(a.shape[:-1] + (C, Mc)), -1, 0), b
    )

    fac, Dhinv, DU = fact.fac, fact.Dhinv, fact.DU

    def fwd(bt_prev, inputs):
        fac_j, b_j = inputs
        bt_j = b_j - _mv(fac_j, bt_prev)
        return bt_j, bt_j

    zero_vec = df_zeros_like(bc[0])
    _, bt = jax.lax.scan(fwd, zero_vec, (fac, bc))

    def bwd(y_next, inputs):
        Dhinv_j, DU_j, bt_j = inputs
        y_j = _mv(Dhinv_j, bt_j) - _mv(DU_j, y_next)
        return y_j, y_j

    _, y = jax.lax.scan(bwd, zero_vec, (Dhinv, DU, bt), reverse=True)

    if fact.red is None:  # single chunk: no interface correction
        return _from_chunks(y, M)

    yred = df_concat([y[0], y[-1]], axis=-2)
    if isinstance(fact.red, RingReducedDF):
        z = fact.red.solve(yred)
    else:
        z = _pcr_solve(fact.red, yred)
    ztop, zbot = z[..., :s, :], z[..., s:, :]
    if fact.cyclic:
        xm1_bot = df_roll(zbot, 1)
        xp1_top = df_roll(ztop, -1)
    else:
        xm1_bot = df_concat(
            [df_zeros_like(zbot[..., :1]), zbot[..., :-1]], axis=-1
        )
        xp1_top = df_concat(
            [ztop[..., 1:], df_zeros_like(ztop[..., :1])], axis=-1
        )
    Wb, Vb = fact.W, fact.V
    extra = y.ndim - 3
    if extra > 0:
        expand = (slice(None),) + (None,) * extra
        Wb = Wb[expand]
        Vb = Vb[expand]
    x = y - _mv(Wb, xm1_bot) - _mv(Vb, xp1_top)
    return _from_chunks(x, M)


def _tri_factor(L, D, U):
    M = L.shape[-1]
    if M > 1:
        # scan-based even at small M: a sequential C=1 Thomas sweep traces
        # its body ONCE, where unrolled PCR levels on wide recursion blocks
        # (2s x 2s) dominate the whole module's HLO count
        return _chunked_factor(L, D, U, _pick_chunks(M))
    return _pcr_factor(L, D, U)


def _tri_solve(fact, b):
    if isinstance(fact, ChunkedFactorDF):
        return _chunked_solve(fact, b)
    return _pcr_solve(fact, b)


# ---------------------------------------------------------------------------
# public interface
# ---------------------------------------------------------------------------

def _dense_matvec(A, v):
    """(..., m, n) DF dense @ (..., n) DF -> (..., m): tiny Woodbury blocks
    (no dot — unrolled elementwise, exactly like _mm)."""
    m, n = A.shape[-2], A.shape[-1]
    rows = []
    for i in range(m):
        acc = A[..., i, 0] * v[..., 0]
        for q in range(1, n):
            acc = acc + A[..., i, q] * v[..., q]
        rows.append(acc)
    return df_stack(rows, axis=-1)


class BandedFactorizationDF:
    """df64 twin of banded.BandedFactorization."""

    def __init__(self, tri_fact, g, s, N, nvar, periodic, wood_Z=None,
                 wood_cap_inv=None, halo=0):
        self.tri_fact = tri_fact
        self.g, self.s, self.N, self.nvar = g, s, N, nvar
        self.periodic = periodic
        self.wood_Z = wood_Z
        self.wood_cap_inv = wood_cap_inv
        self.halo = halo

    def _tri_solve_nodes(self, rhs):
        nvar, N, g, s = self.nvar, self.N, self.g, self.s
        M = -(-N // g)
        Np = M * g
        b = rhs
        if Np != N:
            pad = [(0, 0)] * (b.ndim - 1) + [(0, Np - N)]
            b = df_map(lambda a: jnp.pad(a, pad), b)
        b = df_map(lambda a: a.reshape(a.shape[:-1] + (M, g)), b)
        b = df_map(lambda a: jnp.moveaxis(a, -1, -3), b)
        b = df_map(lambda a: a.reshape(a.shape[:-3] + (s, M)), b)
        x = _tri_solve(self.tri_fact, b)
        x = df_map(lambda a: a.reshape(a.shape[:-2] + (g, nvar, M)), x)
        x = df_map(lambda a: jnp.moveaxis(a, -3, -1), x)
        x = df_map(lambda a: a.reshape(a.shape[:-2] + (Np,))[..., :N], x)
        return x

    def solve(self, rhs):
        y = self._tri_solve_nodes(rhs)
        if not self.periodic or self.wood_Z is None:
            return y
        h, nvar, N = self.halo, self.nvar, self.N
        P = nvar * h
        y_end = df_map(
            lambda a: jnp.moveaxis(a[..., N - h:], -2, -1).reshape(
                a.shape[:-2] + (P,)), y)
        y_top = df_map(
            lambda a: jnp.moveaxis(a[..., :h], -2, -1).reshape(
                a.shape[:-2] + (P,)), y)
        vty = df_concat([y_end, y_top], axis=-1)
        coef = _dense_matvec(self.wood_cap_inv, vty)
        # corr[..., n, i] = sum_c Z[..., c, n, i] * coef[..., c]
        Zc = self.wood_Z
        n2p = Zc.shape[-3]
        acc = Zc[..., 0, :, :] * coef[..., 0, None, None]
        for c in range(1, n2p):
            acc = acc + Zc[..., c, :, :] * coef[..., c, None, None]
        return y - acc

    __call__ = solve


jax.tree_util.register_pytree_node(
    BandedFactorizationDF,
    lambda f: ((f.tri_fact, f.wood_Z, f.wood_cap_inv),
               (f.g, f.s, f.N, f.nvar, f.periodic, f.halo)),
    lambda aux, leaves: BandedFactorizationDF(
        leaves[0], *aux[:5], leaves[1], leaves[2], aux[5]),
)


def _dense_inv(cap):
    """Small dense df64 inverse via the recursive block-Schur on an
    (..., n, n, 1) stack."""
    capb = df_map(lambda a: a[..., None], cap)
    inv = _small_inv(capb)
    return df_map(lambda a: a[..., 0], inv)


def _attach_woodbury(fact, T, B):
    h, nvar, N = fact.halo, fact.nvar, fact.N
    P = nvar * h
    batch = T.shape[:-2]
    cols = df_zeros(batch + (2 * P, nvar, N))
    T_cols = df_map(
        lambda a: jnp.moveaxis(
            jnp.moveaxis(a, -1, -2).reshape(batch + (P, h, nvar)), -1, -2),
        T)
    cols = cols.at[..., :P, :, :h].set(T_cols)
    B_cols = df_map(
        lambda a: jnp.moveaxis(
            jnp.moveaxis(a, -1, -2).reshape(batch + (P, h, nvar)), -1, -2),
        B)
    cols = cols.at[..., P:, :, N - h:].set(B_cols)
    Z = fact._tri_solve_nodes(cols)
    Z_end = df_map(
        lambda a: jnp.moveaxis(a[..., N - h:], -2, -1).reshape(
            batch + (2 * P, P)), Z)
    Z_top = df_map(
        lambda a: jnp.moveaxis(a[..., :h], -2, -1).reshape(
            batch + (2 * P, P)), Z)
    VtZ = df_concat([Z_end, Z_top], axis=-1)
    eye = jnp.eye(2 * P, dtype=jnp.float32)
    cap = df_map(lambda a: jnp.moveaxis(a, -1, -2), VtZ)
    cap = DF.wrap(cap.hi + eye, cap.lo)  # I + Vt Z (eye is exact in f32)
    fact.wood_Z = Z
    fact.wood_cap_inv = _dense_inv(cap)
    return fact


def factor_banded_df(A_bands, periodic: bool) -> BandedFactorizationDF:
    """Factor a DF block-banded matrix (..., window, nvar, nvar, N).

    Periodic systems whose grid folds cleanly (g | N, a usable divisor
    chunk count) take the RING-NATIVE path: the wrap entries stay as
    supernode ring couplings and close at the reduced chunk-interface
    level — no full-size Woodbury spike columns (which cost ~4 extra
    tri-solves per factorization, measured ~40% of the df64 RODASPR step
    at N=1e6)."""
    W, nvar, _, N = A_bands.shape[-4:]
    h = W // 2
    g = max(h, 1)
    if N < 2 * g:
        raise ValueError(f"banded solver requires N >= {2*g} (got {N})")
    if periodic and h > 0 and N % g == 0:
        M = N // g
        C = _pick_chunks_divisor(M) if M >= _CHUNK_MIN_M else None
        if C is not None:
            L, D, U, g, s, M, Np = _assemble_blocks(A_bands,
                                                    keep_ring=True)
            tri = _chunked_factor(L, D, U, C, cyclic=True)
            return BandedFactorizationDF(tri, g, s, N, nvar, True, halo=h)
    bands_tri, T, B = _extract_wrap(A_bands, periodic)
    L, D, U, g, s, M, Np = _assemble_blocks(bands_tri)
    tri = _tri_factor(L, D, U)
    fact = BandedFactorizationDF(tri, g, s, N, nvar, periodic, halo=h)
    if not periodic or h == 0:
        return fact
    return _attach_woodbury(fact, T, B)


def axpy_bands_df(alpha, beta, J_bands):
    """``alpha * I + beta * J`` on DF bands; alpha/beta may be DF scalars."""
    W, nvar = J_bands.shape[-4], J_bands.shape[-3]
    h = W // 2
    A = J_bands * beta if isinstance(beta, DF) else J_bands * float(beta)
    diag_idx = jnp.arange(nvar)
    return A.at[..., h, diag_idx, diag_idx, :].add(alpha)


def banded_matvec_ext_df(bands, v_ext):
    """DF local band application against a pre-haloed DF vector — the df64
    twin of parallel/spatial.banded_matvec_ext (no einsum/dot: the block
    contraction goes through _mv's unrolled DF multiply-adds).  Couplings
    to neighbor shards are applied through the ghost cells, so this is the
    TRUE distributed operator for sharded residual-refinement passes."""
    W, nvar, _, Nl = bands.shape[-4:]
    out = None
    for k in range(W):
        term = _mv(bands[..., k, :, :, :], v_ext[..., k: k + Nl])
        out = term if out is None else out + term
    return out


def banded_matvec_df(bands, u, periodic: bool):
    """DF banded matvec (residual checks / refinement)."""
    W, nvar, _, N = bands.shape[-4:]
    h = W // 2
    out = None
    for k in range(W):
        off = k - h
        if periodic:
            u_shift = df_roll(u, -off) if off else u
        else:
            zero = df_zeros_like(u)
            if off == 0:
                u_shift = u
            elif off > 0:
                u_shift = zero.at[..., : N - off].set(u[..., off:])
            else:
                u_shift = zero.at[..., -off:].set(u[..., : N + off])
        # term[..., m, i] = sum_n bands[..., k, m, n, i] * u_shift[..., n, i]
        term = _mv(bands[..., k, :, :, :], u_shift)
        out = term if out is None else out + term
    return out
