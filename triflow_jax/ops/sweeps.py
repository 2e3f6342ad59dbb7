"""Chunked-Thomas sweeps as Pallas kernels for NVIDIA GPUs (Triton route).

The chunked Thomas/SPIKE solver in ops/banded.py splits a block-tridiagonal
system of M block rows into C contiguous chunks of Mc rows.  Each chunk is
eliminated by a sequential Thomas sweep; the chunks are independent, so the
sweep is vectorised over C.  As a ``lax.scan`` every one of the Mc rows is a
separate loop iteration of several small XLA kernels, which makes the sweep
launch-bound on a GPU.  These kernels run a whole sweep in one launch:

* one thread per chunk: a program owns ``bc`` consecutive chunks, and the
  chunk index is the contiguous (minor) axis of every operand, so each row
  load or store of a program is one coalesced transaction;
* the Mc-row recurrence is an in-kernel ``fori_loop`` whose s x s carries
  are held in registers as nested lists of (bc,) vectors, so any block size
  works, not only powers of two;
* the factor kernel can assemble ``alpha*I + beta*J`` from the raw Jacobian
  bands inside the forward sweep (no block arrays are built in memory);
* float32 and float64; ``jax.vmap`` adds a grid axis (ensembles).

Layouts (shared with ops/banded.py): block arrays are (Mc, s, s, C) and
vectors (Mc, R, s, C) with R independent right-hand sides.  Each factor
returns (fac, Dhinv, DU, W, V) with the conventions of the ``lax.scan``
reference in ops/banded.py: row 0 of every chunk has no tri-part left
coupling (that block becomes the left spike's seed), and row Mc-1 no right
coupling (the right spike's seed).

``interpret=True`` runs the same kernels through the Pallas interpreter,
which is how they are tested without a GPU.
"""

from __future__ import annotations

import functools
import operator

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


# ---------------------------------------------------------------------------
# s x s block algebra on nested lists of (bc,) vectors
# ---------------------------------------------------------------------------

def _dot(terms):
    return functools.reduce(operator.add, terms)


def _mm(a, b):
    """(m x k) @ (k x n) block product; rectangular for odd Schur splits."""
    k, n = len(b), len(b[0])
    return [[_dot([row[q] * b[q][j] for q in range(k)]) for j in range(n)]
            for row in a]


def _mv(a, v):
    return [_dot([row[q] * v[q] for q in range(len(v))]) for row in a]


def _sub(a, b):
    return [[x - y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def _neg(a):
    return [[-x for x in r] for r in a]


def _inv(D):
    """Closed-form 1x1/2x2 inverse, block-Schur recursion above (the same
    algebra as ops/banded._small_inv)."""
    s = len(D)
    if s == 1:
        return [[1.0 / D[0][0]]]
    if s == 2:
        (a, b), (c, d) = D
        r = 1.0 / (a * d - b * c)
        return [[d * r, -b * r], [-c * r, a * r]]
    p = s // 2
    A = [row[:p] for row in D[:p]]
    B = [row[p:] for row in D[:p]]
    C = [row[:p] for row in D[p:]]
    Dd = [row[p:] for row in D[p:]]
    Ainv = _inv(A)
    AinvB = _mm(Ainv, B)
    CAinv = _mm(C, Ainv)
    Sinv = _inv(_sub(Dd, _mm(C, AinvB)))
    top_left = [[x + y for x, y in zip(r1, r2)]
                for r1, r2 in zip(Ainv, _mm(AinvB, _mm(Sinv, CAinv)))]
    top_right = _neg(_mm(AinvB, Sinv))
    bot_left = _neg(_mm(Sinv, CAinv))
    return ([tl + tr for tl, tr in zip(top_left, top_right)]
            + [bl + sr for bl, sr in zip(bot_left, Sinv)])


def _load_blk(ref, j, s):
    return [[ref[j, a, b, :] for b in range(s)] for a in range(s)]


def _store_blk(ref, j, blk):
    for a, row in enumerate(blk):
        for b, v in enumerate(row):
            ref[j, a, b, :] = v


def _load_vec(ref, j, s):
    return [ref[j, a, :] for a in range(s)]


def _store_vec(ref, j, vec):
    for a, v in enumerate(vec):
        ref[j, a, :] = v


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

#: chunks per program: one chunk per thread of 4 warps
_BLOCK_C = 128


def _launch(C):
    """(chunks per program, compiler params) for C chunks (a power of two
    or any multiple of _BLOCK_C)."""
    bc = min(C, _BLOCK_C)
    if C % bc:
        raise ValueError(f"chunk count {C} is not a multiple of {bc}")
    return bc, plgpu.CompilerParams(num_warps=max(1, bc // 32),
                                    num_stages=1)


def _barrier(interpret):
    """Order the forward pass's global stores before the backward pass's
    loads across the threads of a program (the interpreter runs a program
    as one sequential trace and needs none)."""
    if not interpret:
        plgpu.debug_barrier()


def _sweep_factor(load_row, s, Mc, refs_out, interpret):
    """Forward Thomas elimination then backward spike construction for the
    chunks of one program.  ``load_row(j, k)`` returns block k (0: L, 1: D,
    2: U) of row j.  The forward pass parks wt (the left spike before back
    substitution) in W's storage; the backward pass overwrites it."""
    fac_ref, dhinv_ref, du_ref, w_ref, v_ref = refs_out

    # row 0: no tri-part left coupling; L_0 seeds the left spike
    dhinv = _inv(load_row(0, 1))
    zblk = [[jnp.zeros_like(dhinv[0][0])] * s for _ in range(s)]
    wt = load_row(0, 0)
    _store_blk(fac_ref, 0, zblk)
    _store_blk(dhinv_ref, 0, dhinv)
    _store_blk(w_ref, 0, wt)

    def fwd(j, carry):
        dhinv_p, u_p, wt_p = carry
        fac = _mm(load_row(j, 0), dhinv_p)
        dhinv_j = _inv(_sub(load_row(j, 1), _mm(fac, u_p)))
        wt_j = _neg(_mm(fac, wt_p))
        _store_blk(fac_ref, j, fac)
        _store_blk(dhinv_ref, j, dhinv_j)
        _store_blk(w_ref, j, wt_j)
        return dhinv_j, load_row(j, 2), wt_j

    jax.lax.fori_loop(1, Mc, fwd, (dhinv, load_row(0, 2), wt))
    _barrier(interpret)

    # row Mc-1: no tri-part right coupling; U_{Mc-1} seeds the right spike
    last = Mc - 1
    dhinv = _load_blk(dhinv_ref, last, s)
    w = _mm(dhinv, _load_blk(w_ref, last, s))
    v = _mm(dhinv, load_row(last, 2))
    _store_blk(du_ref, last, zblk)
    _store_blk(w_ref, last, w)
    _store_blk(v_ref, last, v)

    def bwd(i, carry):
        w_n, v_n = carry
        j = last - 1 - i
        dhinv_j = _load_blk(dhinv_ref, j, s)
        du = _mm(dhinv_j, load_row(j, 2))
        w_j = _sub(_mm(dhinv_j, _load_blk(w_ref, j, s)), _mm(du, w_n))
        v_j = _neg(_mm(du, v_n))
        _store_blk(du_ref, j, du)
        _store_blk(w_ref, j, w_j)
        _store_blk(v_ref, j, v_j)
        return w_j, v_j

    jax.lax.fori_loop(0, last, bwd, (w, v))


def _factor_call(kernel, inputs, in_specs, Mc, s, C, dtype, interpret):
    bc, params = _launch(C)
    blk = pl.BlockSpec((Mc, s, s, bc), lambda i: (0, 0, 0, i))
    shape = jax.ShapeDtypeStruct((Mc, s, s, C), dtype)
    return pl.pallas_call(
        kernel,
        grid=(C // bc,),
        in_specs=in_specs(bc),
        out_specs=[blk] * 5,
        out_shape=[shape] * 5,
        compiler_params=params,
        interpret=interpret,
        name="chunked_thomas_factor",
    )(*inputs)


def factor_blocks(Lc, Dc, Uc, *, interpret=False):
    """Factor sweeps over assembled blocks in chunk layout (Mc, s, s, C).

    ``Lc[0]`` holds each chunk's coupling to the previous chunk and
    ``Uc[-1]`` its coupling to the next one (both zero at the ends of the
    system).  Returns fac, Dhinv, DU, W, V, each (Mc, s, s, C)."""
    Mc, s, _, C = Lc.shape

    def kernel(l_ref, d_ref, u_ref, *outs):
        refs = (l_ref, d_ref, u_ref)
        _sweep_factor(lambda j, k: _load_blk(refs[k], j, s), s, Mc, outs,
                      interpret)

    def in_specs(bc):
        return [pl.BlockSpec((Mc, s, s, bc), lambda i: (0, 0, 0, i))] * 3

    return _factor_call(kernel, (Lc, Dc, Uc), in_specs, Mc, s, C, Dc.dtype,
                        interpret)


def factor_bands(bands_c, alpha, beta, M, *, interpret=False):
    """Factor sweeps that assemble ``alpha*I + beta*J`` from raw bands.

    ``bands_c`` is (Mc, W, nvar, nvar, g, C): ``bands_c[j, k, m, n, a, c]``
    is band k of J at node ``(c*Mc + j)*g + a``, zero past the M real block
    rows.  Supernode blocks follow ops/banded._assemble_blocks; the left
    coupling of block row 0 and the right coupling of block row M-1 (the
    periodic wrap, handled by the Woodbury correction) are masked off.
    Returns fac, Dhinv, DU, W, V, each (Mc, s, s, C)."""
    Mc, W, nvar, _, g, C = bands_c.shape
    h = W // 2
    s = nvar * g
    dtype = bands_c.dtype
    ab = jnp.stack([jnp.asarray(alpha, dtype), jnp.asarray(beta, dtype)])

    def kernel(ab_ref, b_ref, *outs):
        alpha_, beta_ = ab_ref[0], ab_ref[1]
        bc = b_ref.shape[-1]
        chunk = pl.program_id(0) * bc + jax.lax.broadcasted_iota(
            jnp.int32, (bc,), 0)

        def load_row(j, k):
            dblock = k - 1
            grow = chunk * Mc + j
            zero = jnp.zeros((bc,), dtype)
            rows = []
            for a in range(g):
                for m in range(nvar):
                    row = []
                    for bb in range(g):
                        for n in range(nvar):
                            delta = (bb - a) + dblock * g
                            if abs(delta) > h:
                                row.append(zero)
                                continue
                            val = beta_ * b_ref[j, h + delta, m, n, a, :]
                            if dblock == 0 and a == bb and m == n:
                                val = val + alpha_
                            elif dblock == -1:
                                val = jnp.where(grow == 0, 0.0, val)
                            elif dblock == 1:
                                val = jnp.where(grow == M - 1, 0.0, val)
                            row.append(val)
                    rows.append(row)
            return rows

        _sweep_factor(load_row, s, Mc, outs, interpret)

    def in_specs(bc):
        return [pl.BlockSpec((2,), lambda i: (0,)),
                pl.BlockSpec((Mc, W, nvar, nvar, g, bc),
                             lambda i: (0, 0, 0, 0, 0, i))]

    return _factor_call(kernel, (ab, bands_c), in_specs, Mc, s, C, dtype,
                        interpret)


def solve(fac, Dhinv, DU, bc, *, interpret=False):
    """Both Thomas solve sweeps in one launch: ``bc`` is (Mc, R, s, C) and
    the result has the same shape.  The forward pass parks its partial
    solution in the output, which the backward pass overwrites."""
    Mc, s, _, C = fac.shape
    R = bc.shape[1]
    nb, params = _launch(C)

    def kernel(fac_ref, dhinv_ref, du_ref, b_ref, y_ref):
        bt = _load_vec(b_ref, 0, s)
        _store_vec(y_ref, 0, bt)

        def fwd(j, bt_p):
            mv = _mv(_load_blk(fac_ref, j, s), bt_p)
            bt_j = [x - y for x, y in zip(_load_vec(b_ref, j, s), mv)]
            _store_vec(y_ref, j, bt_j)
            return bt_j

        jax.lax.fori_loop(1, Mc, fwd, bt)
        _barrier(interpret)
        last = Mc - 1
        y = _mv(_load_blk(dhinv_ref, last, s), _load_vec(y_ref, last, s))
        _store_vec(y_ref, last, y)

        def bwd(i, y_n):
            j = last - 1 - i
            a = _mv(_load_blk(dhinv_ref, j, s), _load_vec(y_ref, j, s))
            b = _mv(_load_blk(du_ref, j, s), y_n)
            y_j = [x - z for x, z in zip(a, b)]
            _store_vec(y_ref, j, y_j)
            return y_j

        jax.lax.fori_loop(0, last, bwd, y)

    blk = pl.BlockSpec((Mc, s, s, nb), lambda i, r: (0, 0, 0, i))
    vec = pl.BlockSpec((Mc, None, s, nb), lambda i, r: (0, r, 0, i))
    return pl.pallas_call(
        kernel,
        grid=(C // nb, R),
        in_specs=[blk, blk, blk, vec],
        out_specs=vec,
        out_shape=jax.ShapeDtypeStruct(bc.shape, bc.dtype),
        compiler_params=params,
        interpret=interpret,
        name="chunked_thomas_solve",
    )(fac, Dhinv, DU, bc)
