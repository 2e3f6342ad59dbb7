"""Device-resident linear algebra for block-banded systems.

The implicit schemes repeatedly solve ``(alpha*I - beta*J) x = b`` where J is
the structurally banded Jacobian emitted by the compiler
(shape ``(window, nvar, nvar, N)``).  The reference hands the equivalent CSC
matrix to SuperLU on the host (upstream triflow/core/schemes.py:148-163
and :553-557); here the solve itself runs on the device:

1. the scalar banded system is grouped into **supernodes** of ``g = max(h, 1)``
   grid nodes, turning it into a block-tridiagonal system with dense
   ``s = nvar*g`` blocks;
2. small systems are factored by block **parallel cyclic reduction** (PCR):
   log2(M) levels of batched small-matrix algebra, each fully parallel over
   blocks; large ones by **chunked Thomas / SPIKE**: C independent Thomas
   sweeps over contiguous chunks plus a small PCR-solved interface system
   (on NVIDIA GPUs the sweeps are Pallas kernels, ops/sweeps.py);
3. periodic boundaries add wrap-around entries confined to the first/last
   ``h`` nodes; they are peeled off as a rank-``2*nvar*h`` correction and
   reinstated with the **Sherman–Morrison–Woodbury** identity, so a single
   non-cyclic factorization serves both boundary modes.

Like SuperLU in the reference ROW scheme, the factorization is computed once
per step and reused for every stage solve (``factor_banded`` /
``solve_banded`` mirror scipy's ``factorized`` split).

All entry points support arbitrary leading batch dimensions and ``jax.vmap``
(ensembles) and are pure jit-friendly functions.
"""

from __future__ import annotations

import contextlib
import math

import jax
import jax.numpy as jnp

from . import sweeps


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def identity_bands(window: int, nvar: int, N: int, dtype=jnp.float64):
    """Banded representation of the identity matrix."""
    bands = jnp.zeros((window, nvar, nvar, N), dtype=dtype)
    h = window // 2
    eye = jnp.eye(nvar, dtype=dtype)[:, :, None]
    return bands.at[h].set(jnp.broadcast_to(eye, (nvar, nvar, N)))


def axpy_bands(alpha, beta, J_bands):
    """``alpha * I + beta * J`` in banded form (used to build the implicit
    system matrices of the Theta and ROW schemes)."""
    J_bands = jnp.asarray(J_bands)
    W, nvar = J_bands.shape[-4], J_bands.shape[-3]
    h = W // 2
    A = beta * J_bands
    diag_idx = jnp.arange(nvar)
    return A.at[..., h, diag_idx, diag_idx, :].add(alpha)


def banded_matvec(bands, u, periodic: bool):
    """``(A @ u)`` for A in banded layout; u has shape (..., nvar, N).

    Out-of-range columns contribute zero in edge mode (the compiler already
    folded ghost dependencies onto the boundary columns).  Written as
    multiply-and-sum so float32 never takes a reduced-precision matmul
    path."""
    W, nvar, _, N = bands.shape[-4:]
    h = W // 2
    bands = jnp.asarray(bands); u = jnp.asarray(u)
    out = jnp.zeros_like(u)
    for k in range(W):
        off = k - h
        if periodic:
            u_shift = jnp.roll(u, -off, axis=-1) if off else u
        else:
            # zero-padded shift: columns outside the domain do not exist
            u_shift = jnp.zeros_like(u)
            if off == 0:
                u_shift = u
            elif off > 0:
                u_shift = u_shift.at[..., : N - off].set(u[..., off:])
            else:
                u_shift = u_shift.at[..., -off:].set(u[..., : N + off])
        out = out + jnp.sum(bands[..., k, :, :, :] * u_shift[..., None, :, :],
                            axis=-2)
    return out


# ---------------------------------------------------------------------------
# supernode assembly
# ---------------------------------------------------------------------------

def _wrapped_indices(W: int, nvar: int, N: int):
    """Static index lists of the periodic wrap-around entries.

    Returns (top, bottom) lists of tuples
    ``(k, i, local_row_node, local_col_node)`` at node granularity."""
    h = W // 2
    top, bottom = [], []
    for i in range(h):
        for k in range(h - i):  # i + k - h < 0
            top.append((k, i, i, i + k))  # col node = (i+k-h) % N -> local i+k
    for di in range(h):  # i = N-1-di
        i = N - 1 - di
        for k in range(W - 1, W - 1 - (h - di), -1):  # i + k - h > N-1
            j = i + k - h - N  # in [0, h)
            bottom.append((k, i, h - 1 - di, j))
    return top, bottom


def _extract_wrap(bands, periodic: bool):
    """Split periodic wrap entries out of the bands.

    Returns (bands_tri, T, B): T is (..., P, P) coupling the first h nodes to
    the last h nodes (P = nvar*h); B couples last h to first h.  For the edge
    mode both are None and bands are returned unchanged."""
    bands = jnp.asarray(bands)
    W, nvar, _, N = bands.shape[-4:]
    h = W // 2
    if not periodic or h == 0:
        return bands, None, None
    bands_tri = bands
    T, B = _wrap_blocks(bands, 1.0)
    top, bottom = _wrapped_indices(W, nvar, N)
    for (k, i, _r, _c) in top + bottom:
        bands_tri = bands_tri.at[..., k, :, :, i].set(0.0)
    return bands_tri, T, B


def _wrap_blocks(bands, scale):
    """The (..., P, P) periodic corner blocks (T, B) of ``scale * bands``."""
    W, nvar, _, N = bands.shape[-4:]
    P = nvar * (W // 2)
    batch = bands.shape[:-4]
    T = jnp.zeros(batch + (P, P), dtype=bands.dtype)
    B = jnp.zeros(batch + (P, P), dtype=bands.dtype)
    top, bottom = _wrapped_indices(W, nvar, N)
    for (k, i, r, c) in top:
        T = T.at[..., r * nvar:(r + 1) * nvar, c * nvar:(c + 1) * nvar].set(
            scale * bands[..., k, :, :, i])
    for (k, i, r, c) in bottom:
        B = B.at[..., r * nvar:(r + 1) * nvar, c * nvar:(c + 1) * nvar].set(
            scale * bands[..., k, :, :, i])
    return T, B


def _assemble_blocks(bands):
    """Assemble block-tridiagonal (L, D, U) of shape (..., s, s, M) from the
    (already wrap-free) bands.  N is padded to a multiple of g with identity
    rows; M = ceil(N/g).

    The block index M is the minor dimension and the small s x s block dims
    lead, so every block operation vectorizes over M.  The node index N
    splits as (M, g) for free (g is minor-most); ONE transpose moves the
    local-node index g to the front, after which every block element is a
    contiguous (M,)-slice."""
    bands = jnp.asarray(bands)
    W, nvar, _, N = bands.shape[-4:]
    h = W // 2
    g = max(h, 1)
    s = nvar * g
    M = -(-N // g)
    Np = M * g
    batch = bands.shape[:-4]
    if Np != N:
        pad_width = [(0, 0)] * (bands.ndim - 1) + [(0, Np - N)]
        bands = jnp.pad(bands, pad_width)
        diag_idx = jnp.arange(nvar)
        bands = bands.at[..., h, diag_idx, diag_idx, N:].set(1.0)

    # (..., W, nvar, nvar, M, g) -> (..., g, W, nvar, nvar, M); the barrier
    # makes XLA materialize the transpose once instead of fusing the gather
    # into each of the block-element slices below
    bands_t = jnp.moveaxis(
        bands.reshape(batch + (W, nvar, nvar, M, g)), -1, -5
    )
    bands_t = jax.lax.optimization_barrier(bands_t)
    zero = jnp.zeros(batch + (M,), dtype=bands.dtype)

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
                rows.append(jnp.stack(row, axis=-2))
        return jnp.stack(rows, axis=-3)

    L = block(-g)
    D = block(0)
    U = block(g)
    # couplings that would reach outside the block range are structurally
    # zero already (edge folding / wrap extraction), but enforce the
    # invariants L[0] = 0, U[M-1] = 0 defensively:
    L = L.at[..., 0].set(0.0)
    U = U.at[..., M - 1].set(0.0)
    return L, D, U, g, s, M, Np


# ---------------------------------------------------------------------------
# small-block algebra
# ---------------------------------------------------------------------------

def _stack_block(rows):
    """Build an (..., s, s, M) block from a nested list of (..., M) entries."""
    return jnp.stack([jnp.stack(r, axis=-2) for r in rows], axis=-3)


def _mm(a, b):
    """Block matmul over (..., m, k, M) @ (..., k, n, M): unrolled
    multiply-adds elementwise over the minor dimension M (blocks are tiny,
    1-8; rectangular operands arise in the odd-size Schur splits)."""
    m, k = a.shape[-3], a.shape[-2]
    n = b.shape[-2]
    return _stack_block(
        [
            [
                sum(a[..., i, q, :] * b[..., q, j, :] for q in range(k))
                for j in range(n)
            ]
            for i in range(m)
        ]
    )


def _mv(a, b):
    """Block matvec: (..., m, k, M) @ (..., k, M) -> (..., m, M)."""
    m, k = a.shape[-3], a.shape[-2]
    return jnp.stack(
        [
            sum(a[..., i, q, :] * b[..., q, :] for q in range(k))
            for i in range(m)
        ],
        axis=-2,
    )


def _small_inv(D):
    """Batched inverse of small (s, s, M) blocks.

    The solver's block sizes are tiny (s = nvar*halo, typically 1-8), so
    closed-form 2x2 / recursive block-Schur inverses keep everything
    elementwise over M instead of a batched LU of huge batches of tiny
    matrices.  Odd sizes split unevenly (p = s//2 vs s - p) through the
    rectangular ``_mm``."""
    s = D.shape[-3]
    if s == 1:
        return 1.0 / D
    if s == 2:
        a = D[..., 0, 0, :]
        b = D[..., 0, 1, :]
        c = D[..., 1, 0, :]
        d = D[..., 1, 1, :]
        inv_det = 1.0 / (a * d - b * c)
        return _stack_block(
            [[d * inv_det, -b * inv_det], [-c * inv_det, a * inv_det]]
        )
    if s <= 8:
        # block-Schur: [[A, B], [C, D]]^-1, recursing down to the closed
        # 1x1/2x2 forms
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
        top = jnp.concatenate([top_left, top_right], axis=-2)
        bot = jnp.concatenate([bot_left, Sinv], axis=-2)
        return jnp.concatenate([top, bot], axis=-3)
    # large sizes: fall back to the generic batched inverse (batch-major)
    Dm = jnp.moveaxis(D, -1, -3)
    return jnp.moveaxis(jnp.linalg.inv(Dm), -3, -1)


def _roll_blocks(arr, shiftn):
    return jnp.roll(arr, shiftn, axis=-1)


# ---------------------------------------------------------------------------
# parallel cyclic reduction: the small-M path and the interface systems
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class PcrFactor:
    """PCR factorization: per-level (alpha, beta) operators stacked as
    (..., nlev, s, s, M), plus the final block inverse (..., s, s, M)."""

    def __init__(self, alphas, betas, Dinv):
        self.alphas = alphas
        self.betas = betas
        self.Dinv = Dinv

    def tree_flatten(self):
        return (self.alphas, self.betas, self.Dinv), None

    @classmethod
    def tree_unflatten(cls, _aux, leaves):
        return cls(*leaves)


def _pcr_distances(M):
    """Coupling distance 2**l of each of the ceil(log2 M) PCR levels."""
    return 2 ** jnp.arange((M - 1).bit_length(), dtype=jnp.int32)


def _pcr_factor(L, D, U, cyclic: bool = False):
    """Parallel-cyclic-reduction factorization of a block-tridiagonal system
    given as (..., s, s, M) stacks.

    With ``cyclic=True`` (requires power-of-two M) the ring couplings are
    kept: the rolls wrap naturally and after log2(M) levels the leftover
    distance-M couplings ARE the diagonal (row i +- M = row i), absorbed into
    the final block inverse — periodic closure with no Woodbury correction.

    PCR keeps all M equations at every level (no odd/even shrinking): level
    l eliminates the couplings at distance d = 2**l by combining each row
    with the rows d above/below, so after ceil(log2(M)) levels the system
    is block-diagonal.  Compared to classic cyclic reduction this does
    O(M log M) block work instead of O(M), but every level is the same
    fixed-shape elementwise pass with rolls — no stride-2 gathers, no shape
    changes, no back-substitution — so the levels run as one ``lax.scan``
    over d and the program holds a single copy of the level.

    Returns the per-level (alpha, beta) reduction operators plus the final
    block-diagonal inverse; a solve is then log2(M) fused multiply-add
    passes over the RHS."""
    M = L.shape[-1]
    if cyclic and M & (M - 1):
        raise ValueError("cyclic PCR requires power-of-two M")
    idx = jnp.arange(M)

    def level(carry, d):
        L, D, U = carry
        Dinv = _small_inv(D)
        alpha = -_mm(L, _roll_blocks(Dinv, d))
        beta = -_mm(U, _roll_blocks(Dinv, -d))
        if not cyclic:
            # rows whose +-d neighbor falls outside the system keep no
            # coupling (the rolled operands would be wrap-around junk)
            alpha = jnp.where(idx >= d, alpha, 0.0)
            beta = jnp.where(idx < M - d, beta, 0.0)
        newD = (D + _mm(alpha, _roll_blocks(U, d))
                + _mm(beta, _roll_blocks(L, -d)))
        newL = _mm(alpha, _roll_blocks(L, d))
        newU = _mm(beta, _roll_blocks(U, -d))
        return (newL, newD, newU), (alpha, beta)

    (L, D, U), (alphas, betas) = jax.lax.scan(level, (L, D, U),
                                              _pcr_distances(M))
    if cyclic:
        # the surviving couplings sit at distance M == 0 (mod M): diagonal
        D = D + L + U
    return PcrFactor(jnp.moveaxis(alphas, 0, -4), jnp.moveaxis(betas, 0, -4),
                     _small_inv(D))


def _pcr_solve(fact, b):
    """Level-loop solve with a PcrFactor; b has shape (..., s, M)."""
    def level(b, inputs):
        alpha, beta, d = inputs
        b = (b + _mv(alpha, jnp.roll(b, d, axis=-1))
             + _mv(beta, jnp.roll(b, -d, axis=-1)))
        return b, None

    M = b.shape[-1]
    b, _ = jax.lax.scan(level, b, (jnp.moveaxis(fact.alphas, -4, 0),
                                   jnp.moveaxis(fact.betas, -4, 0),
                                   _pcr_distances(M)))
    return _mv(fact.Dinv, b)


# ---------------------------------------------------------------------------
# chunked Thomas / SPIKE (Wang's algorithm): the large-M path
# ---------------------------------------------------------------------------
#
# PCR does O(M log M) block work in log M full-width passes; for large M the
# profitable layout is C independent *contiguous* chunks of Mc = M/C rows,
# each eliminated by a sequential Thomas sweep vectorized across the C
# chunks — O(M) work.  The chunks couple only through their first/last rows;
# a reduced block-tridiagonal interface system over C supernodes of size 2s
# is solved with PCR.  This is the single-device twin of the cross-device
# SPIKE decomposition in parallel/spatial.py.
#
# The sweeps have two implementations with identical results: Pallas kernels
# (ops/sweeps.py) where the program is lowered for an NVIDIA GPU, and
# Mc-deep lax.scans everywhere else.  The choice is made per lowering
# platform (lax.platform_dependent), never from the environment.

@jax.tree_util.register_pytree_node_class
class ChunkedFactor:
    """Wang/SPIKE factorization: Thomas operators, spikes and the reduced
    interface PCR factorization."""

    def __init__(self, fac, Dhinv, DU, W, V, red, C, Mc, M, s):
        self.fac = fac
        self.Dhinv = Dhinv
        self.DU = DU
        self.W = W
        self.V = V
        self.red = red
        self.C, self.Mc, self.M, self.s = C, Mc, M, s

    def tree_flatten(self):
        return (self.fac, self.Dhinv, self.DU, self.W, self.V, self.red), \
            (self.C, self.Mc, self.M, self.s)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


#: below this many block rows the PCR path factors the whole system
_CHUNK_MIN_M = 1024
#: least rows per chunk: deeper sweeps mean fewer chunks, so a smaller
#: interface system, at the cost of a longer sequential recurrence
_CHUNK_MIN_DEPTH = 32

_SCAN_SWEEPS = False


@contextlib.contextmanager
def scan_sweeps():
    """Trace the chunked sweeps as ``lax.scan`` on every platform, so the
    GPU kernels can be timed against the plain XLA version of the same
    plan.  Affects only functions first traced inside the block: JAX
    caches a trace per function object, so jit a fresh function here."""
    global _SCAN_SWEEPS
    saved, _SCAN_SWEEPS = _SCAN_SWEEPS, True
    try:
        yield
    finally:
        _SCAN_SWEEPS = saved


def _sweep(kernel, scan, *args):
    """``kernel(*args)`` when lowered for CUDA, ``scan(*args)`` elsewhere."""
    if _SCAN_SWEEPS:
        return scan(*args)
    return jax.lax.platform_dependent(*args, cuda=kernel, default=scan)


def _pick_chunks(M: int) -> int:
    """Power-of-two chunk count with at least _CHUNK_MIN_DEPTH rows per
    chunk: as many independent sweeps as the depth floor allows."""
    C = 1
    while 2 * C * _CHUNK_MIN_DEPTH <= M:
        C *= 2
    return C


def _to_chunks(A, C, Mc):
    """(..., M=C*Mc) -> (Mc, ..., C): sweep axis leading, chunk index minor;
    chunk c owns the contiguous rows [c*Mc, (c+1)*Mc)."""
    A = A.reshape(A.shape[:-1] + (C, Mc))
    return jnp.moveaxis(A, -1, 0)


def _from_chunks(A, M):
    """(Mc, ..., C) -> (..., M) inverse of the chunking."""
    A = jnp.moveaxis(A, 0, -1)          # (..., C, Mc)
    A = A.reshape(A.shape[:-2] + (-1,))  # (..., C*Mc)
    return A[..., :M]


def _pad_rows(A, Mp, fill_identity=False):
    """Pad the block-row axis (last) of (s, s, M) blocks to Mp rows."""
    M = A.shape[-1]
    if Mp == M:
        return A
    if fill_identity:
        s = A.shape[-2]
        pad = jnp.broadcast_to(jnp.eye(s, dtype=A.dtype)[..., None],
                               A.shape[:-1] + (Mp - M,))
    else:
        pad = jnp.zeros(A.shape[:-1] + (Mp - M,), dtype=A.dtype)
    return jnp.concatenate([A, pad], axis=-1)


def _factor_scan(Lc, Dc, Uc):
    """lax.scan factor sweeps over chunk-layout blocks (Mc, s, s, C); same
    contract as ops/sweeps.factor_blocks."""
    Tl, Tr = Lc[0], Uc[-1]
    Lc = Lc.at[0].set(0.0)
    Uc = Uc.at[-1].set(0.0)
    zero_blk = jnp.zeros_like(Tl)
    bW = jnp.zeros_like(Lc).at[0].set(Tl)   # spike-W rhs: Tl at row 0
    bV = jnp.zeros_like(Uc).at[-1].set(Tr)  # spike-V rhs: Tr at last row

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
        DU_j = _mm(Dhinv_j, U_j)
        W_j = _mm(Dhinv_j, wt_j) - _mm(DU_j, W_next)
        V_j = _mm(Dhinv_j, bV_j) - _mm(DU_j, V_next)
        return (W_j, V_j), (DU_j, W_j, V_j)

    _, (DU, W, V) = jax.lax.scan(bwd, (zero_blk, zero_blk),
                                 (Dhinv, Uc, wt, bV), reverse=True)
    return fac, Dhinv, DU, W, V


def _solve_scan(fac, Dhinv, DU, bc):
    """lax.scan solve sweeps; bc is (Mc, R, s, C) (ops/sweeps.solve)."""
    def fwd(bt_prev, inputs):
        fac_j, b_j = inputs
        bt_j = b_j - _mv(fac_j, bt_prev)
        return bt_j, bt_j

    zero_vec = jnp.zeros_like(bc[0])
    _, bt = jax.lax.scan(fwd, zero_vec, (fac, bc))

    def bwd(y_next, inputs):
        Dhinv_j, DU_j, bt_j = inputs
        y_j = _mv(Dhinv_j, bt_j) - _mv(DU_j, y_next)
        return y_j, y_j

    _, y = jax.lax.scan(bwd, zero_vec, (Dhinv, DU, bt), reverse=True)
    return y


def _vmap_leading(fn, nbatch):
    for _ in range(nbatch):
        fn = jax.vmap(fn)
    return fn


def _chunked_factor(L, D, U, C):
    """Wang/SPIKE factorization of a NON-cyclic block-tridiagonal system
    given as (..., s, s, M) stacks (leading axes are batch axes)."""
    if L.ndim > 3:
        return _vmap_leading(lambda *a: _chunked_factor(*a, C), L.ndim - 3)(
            L, D, U)
    s, M = L.shape[-2], L.shape[-1]
    Mc = -(-M // C)
    Mp = Mc * C
    Lc = _to_chunks(_pad_rows(L, Mp), C, Mc)
    Dc = _to_chunks(_pad_rows(D, Mp, fill_identity=True), C, Mc)
    Uc = _to_chunks(_pad_rows(U, Mp), C, Mc)
    fac, Dhinv, DU, W, V = _sweep(sweeps.factor_blocks, _factor_scan,
                                  Lc, Dc, Uc)
    red = _reduced_interface_factor(W, V, C, s)
    return ChunkedFactor(fac, Dhinv, DU, W, V, red, C, Mc, M, s)


def _chunked_factor_bands(J_bands, alpha, beta, C):
    """Chunked factorization of ``alpha*I + beta*J`` straight from the
    banded J (..., W, nvar, nvar, N) with N a multiple of the supernode
    size.  The periodic wrap entries are left out (Woodbury's job).  The
    GPU kernel assembles the blocks inside its forward sweep; elsewhere
    the blocks are assembled in XLA first."""
    if J_bands.ndim > 4:
        fn = _vmap_leading(lambda J, a, b: _chunked_factor_bands(J, a, b, C),
                           J_bands.ndim - 4)
        shape = J_bands.shape[:-4]
        return fn(J_bands, jnp.broadcast_to(alpha, shape),
                  jnp.broadcast_to(beta, shape))
    W_, nvar, _, N = J_bands.shape
    h = W_ // 2
    g = max(h, 1)
    s = nvar * g
    M = N // g
    Mc = -(-M // C)
    Mp = Mc * C
    alpha = jnp.asarray(alpha, J_bands.dtype)
    beta = jnp.asarray(beta, J_bands.dtype)

    def kernel(J, a, b, **kw):
        Jp = jnp.pad(J, [(0, 0)] * 3 + [(0, (Mp - M) * g)])
        bands_c = jnp.transpose(Jp.reshape(W_, nvar, nvar, C, Mc, g),
                                (4, 0, 1, 2, 5, 3))
        return sweeps.factor_bands(bands_c, a, b, M, **kw)

    def scan(J, a, b):
        L, D, U, *_ = _assemble_blocks(axpy_bands(a, b, J))
        return _factor_scan(_to_chunks(_pad_rows(L, Mp), C, Mc),
                            _to_chunks(_pad_rows(D, Mp, True), C, Mc),
                            _to_chunks(_pad_rows(U, Mp), C, Mc))

    fac, Dhinv, DU, Wsp, Vsp = _sweep(kernel, scan, J_bands, alpha, beta)
    red = _reduced_interface_factor(Wsp, Vsp, C, s)
    return ChunkedFactor(fac, Dhinv, DU, Wsp, Vsp, red, C, Mc, M, s)


def _reduced_interface_factor(W, V, C, s):
    """PCR factorization of the chunk-interface system: supernode c =
    (x_c^top, x_c^bot), size 2s:
      x_c^top + W_0  x_{c-1}^bot + V_0  x_{c+1}^top = y_c^top
      x_c^bot + W_L  x_{c-1}^bot + V_L  x_{c+1}^top = y_c^bot"""
    d2 = 2 * s
    dtype = W.dtype
    Lred = jnp.zeros(W.shape[1:-3] + (d2, d2, C), dtype=dtype)
    Ured = jnp.zeros_like(Lred)
    Dred = jnp.broadcast_to(jnp.eye(d2, dtype=dtype)[..., None], Lred.shape)
    Lred = Lred.at[..., :s, s:, :].set(W[0])
    Lred = Lred.at[..., s:, s:, :].set(W[-1])
    Ured = Ured.at[..., :s, :s, :].set(V[0])
    Ured = Ured.at[..., s:, :s, :].set(V[-1])
    # chunk 0 has no left neighbor, chunk C-1 no right neighbor (their
    # couplings are structurally zero for a non-cyclic system, but enforce
    # the PCR invariants)
    Lred = Lred.at[..., 0].set(0.0)
    Ured = Ured.at[..., C - 1].set(0.0)
    return _pcr_factor(Lred, Dred, Ured)


def _chunked_solve(fact, b):
    """Solve with an unbatched _chunked_factor result; b is (R, s, M)."""
    C, Mc, M, s = fact.C, fact.Mc, fact.M, fact.s
    Mp = Mc * C
    if Mp != M:
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, Mp - M)])
    bc = _to_chunks(b, C, Mc)                             # (Mc, R, s, C)
    y = _sweep(sweeps.solve, _solve_scan, fact.fac, fact.Dhinv, fact.DU, bc)

    # reduced interface solve
    yred = jnp.concatenate([y[0], y[-1]], axis=-2)       # (R, 2s, C)
    z = _pcr_solve(fact.red, yred)
    ztop, zbot = z[..., :s, :], z[..., s:, :]
    xm1_bot = jnp.concatenate(
        [jnp.zeros_like(zbot[..., :1]), zbot[..., :-1]], axis=-1
    )
    xp1_top = jnp.concatenate(
        [ztop[..., 1:], jnp.zeros_like(ztop[..., :1])], axis=-1
    )
    x = y - _mv(fact.W[:, None], xm1_bot) - _mv(fact.V[:, None], xp1_top)
    return _from_chunks(x, M)


def _tri_factor(L, D, U):
    """Factor a non-cyclic block-tridiagonal system, picking the chunked
    Thomas/SPIKE path for large M and PCR otherwise."""
    M = L.shape[-1]
    if M >= _CHUNK_MIN_M:
        return _chunked_factor(L, D, U, _pick_chunks(M))
    return _pcr_factor(L, D, U)


def _tri_solve(fact, b):
    """Solve with a _tri_factor result.  b is (*batch, *rhs, s, M) where
    batch matches the factor's leading axes and rhs are extra right-hand
    side axes."""
    nbatch = (fact.fac.ndim - 4 if isinstance(fact, ChunkedFactor)
              else fact.Dinv.ndim - 3)
    lead = b.shape[:-2]
    R = math.prod(lead[nbatch:])
    bR = b.reshape(lead[:nbatch] + (R,) + b.shape[-2:])
    solve = _chunked_solve if isinstance(fact, ChunkedFactor) else _pcr_solve
    x = _vmap_leading(solve, nbatch)(fact, bR)
    return x.reshape(b.shape)


# ---------------------------------------------------------------------------
# public interface
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class BandedFactorization:
    """Reusable factorization of ``A`` given in banded layout (the analog of
    ``scipy.sparse.linalg.factorized`` in the reference ROW scheme,
    schemes.py:148-150)."""

    def __init__(self, tri_fact, g, s, N, nvar, periodic, wood_Z=None,
                 wood_cap_inv=None, halo=0):
        self.tri_fact = tri_fact
        self.g = g
        self.s = s
        self.N = N
        self.nvar = nvar
        self.periodic = periodic
        self.wood_Z = wood_Z              # (..., 2P, nvar, N) pre-solved A^-1 Uw
        self.wood_cap_inv = wood_cap_inv  # (..., 2P, 2P)
        self.halo = halo

    # pytree plumbing -------------------------------------------------------
    def tree_flatten(self):
        leaves = (self.tri_fact, self.wood_Z, self.wood_cap_inv)
        aux = (self.g, self.s, self.N, self.nvar, self.periodic, self.halo)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        tri_fact, wood_Z, wood_cap_inv = leaves
        g, s, N, nvar, periodic, halo = aux
        return cls(tri_fact, g, s, N, nvar, periodic, wood_Z, wood_cap_inv, halo)

    # solve -----------------------------------------------------------------
    def _tri_solve_nodes(self, rhs):
        """rhs (..., nvar, N) -> x (..., nvar, N) via the tridiagonal part."""
        nvar, N, g, s = self.nvar, self.N, self.g, self.s
        M = -(-N // g)
        Np = M * g
        b = rhs
        if Np != N:
            pad = [(0, 0)] * (b.ndim - 1) + [(0, Np - N)]
            b = jnp.pad(b, pad)
        # (..., nvar, M*g) -> (..., s = g*nvar, M): block entry a*nvar + m
        # holds variable m at local node a of supernode I
        b = b.reshape(b.shape[:-1] + (M, g))          # (..., nvar, M, g)
        b = jnp.moveaxis(b, -1, -3)                   # (..., g, nvar, M)
        b = b.reshape(b.shape[:-3] + (s, M))
        x = _tri_solve(self.tri_fact, b)
        x = x.reshape(x.shape[:-2] + (g, nvar, M))
        x = jnp.moveaxis(x, -3, -1)                   # (..., nvar, M, g)
        x = x.reshape(x.shape[:-2] + (Np,))[..., :N]
        return x

    def solve(self, rhs):
        """Solve ``A x = rhs`` with rhs of shape (..., nvar, N)."""
        y = self._tri_solve_nodes(rhs)
        if not self.periodic or self.wood_Z is None:
            return y
        h, nvar, N = self.halo, self.nvar, self.N
        P = nvar * h
        # Vw^T y = [last-h-node entries ; first-h-node entries]
        y_end = jnp.moveaxis(y[..., N - h:], -2, -1).reshape(y.shape[:-2] + (P,))
        y_top = jnp.moveaxis(y[..., :h], -2, -1).reshape(y.shape[:-2] + (P,))
        vty = jnp.concatenate([y_end, y_top], axis=-1)  # (..., 2P)
        hi = jax.lax.Precision.HIGHEST
        coef = jnp.einsum("...ij,...j->...i", self.wood_cap_inv, vty,
                          precision=hi)
        corr = jnp.einsum("...cni,...c->...ni", self.wood_Z, coef,
                          precision=hi)
        return y - corr

    __call__ = solve


def _attach_woodbury(fact: "BandedFactorization", T, B):
    """Attach the Sherman-Morrison-Woodbury periodic-corner correction to a
    non-cyclic factorization.

    A_cyc = A_tri + E_top @ T @ E_end^T + E_end @ B @ E_top^T
          = A_tri + Uw @ Vw^T,
      Uw = [E_top @ T | E_end @ B]  (Ntot x 2P),  Vw = [E_end | E_top]."""
    h, nvar, N = fact.halo, fact.nvar, fact.N
    P = nvar * h
    batch = T.shape[:-2]
    dtype = T.dtype
    # RHS columns of Uw as (..., 2P, nvar, N) node-layout vectors; T rows are
    # scalar indices r = node*nvar + m over the first h nodes
    cols = jnp.zeros(batch + (2 * P, nvar, N), dtype=dtype)
    T_cols = jnp.moveaxis(T, -1, -2).reshape(batch + (P, h, nvar))
    T_cols = jnp.moveaxis(T_cols, -1, -2)  # (..., P, nvar, h)
    cols = cols.at[..., :P, :, :h].set(T_cols)
    B_cols = jnp.moveaxis(B, -1, -2).reshape(batch + (P, h, nvar))
    B_cols = jnp.moveaxis(B_cols, -1, -2)
    cols = cols.at[..., P:, :, N - h:].set(B_cols)
    # Z = A_tri^-1 Uw : one batched tridiagonal solve over the 2P columns
    Z = fact._tri_solve_nodes(cols)
    # capacity = I + Vw^T Z ; Vw^T selects [last h nodes ; first h nodes]
    Z_end = jnp.moveaxis(Z[..., N - h:], -2, -1).reshape(batch + (2 * P, P))
    Z_top = jnp.moveaxis(Z[..., :h], -2, -1).reshape(batch + (2 * P, P))
    VtZ = jnp.concatenate([Z_end, Z_top], axis=-1)  # (..., 2P, 2P)
    cap = jnp.eye(2 * P, dtype=dtype) + jnp.moveaxis(VtZ, -1, -2)
    fact.wood_Z = Z
    # the capacity matrix is tiny: the closed-form block inverse keeps it
    # elementwise instead of a dense LU launch
    if cap.shape[-1] <= 8:
        fact.wood_cap_inv = _small_inv(cap[..., None])[..., 0]
    else:
        fact.wood_cap_inv = jnp.linalg.inv(cap)
    return fact


def factor_banded(A_bands, periodic: bool) -> BandedFactorization:
    """Factor a block-banded matrix given as (..., window, nvar, nvar, N).

    One factorization serves any number of ``solve`` calls (Theta: one per
    step; ROW: one per step, s stage solves — mirroring the reference's
    reuse of the SuperLU factorization across stages, schemes.py:148-163)."""
    W, nvar, _, N = A_bands.shape[-4:]
    h = W // 2
    if N < 2 * max(h, 1):
        raise ValueError(f"banded solver requires N >= {2*max(h,1)} (got {N})")
    bands_tri, T, B = _extract_wrap(A_bands, periodic)
    L, D, U, g, s, M, Np = _assemble_blocks(bands_tri)
    tri = _tri_factor(L, D, U)
    fact = BandedFactorization(tri, g, s, N, nvar, periodic, halo=h)
    if not periodic or h == 0:
        return fact
    return _attach_woodbury(fact, T, B)


def factor_linearized(alpha, beta, J_bands, periodic: bool):
    """Factor ``alpha*I + beta*J`` — the implicit system of the Theta and
    ROW schemes.

    Large grids whose size is a multiple of the supernode size take the
    chunked path straight from the banded J (on a GPU the block assembly
    happens inside the factor kernel) with the periodic corners read off J;
    otherwise this is ``factor_banded(alpha*I + beta*J)``."""
    W, nvar, _, N = J_bands.shape[-4:]
    h = W // 2
    g = max(h, 1)
    M = N // g
    if N % g or M < _CHUNK_MIN_M:
        return factor_banded(axpy_bands(alpha, beta, J_bands), periodic)
    tri = _chunked_factor_bands(J_bands, alpha, beta, _pick_chunks(M))
    fact = BandedFactorization(tri, g, nvar * g, N, nvar, periodic, halo=h)
    if not periodic or h == 0:
        return fact
    T, B = _wrap_blocks(J_bands, beta)
    return _attach_woodbury(fact, T, B)


def solve_banded(A_bands, rhs, periodic: bool):
    """One-shot solve (factor + solve)."""
    return factor_banded(A_bands, periodic).solve(rhs)
