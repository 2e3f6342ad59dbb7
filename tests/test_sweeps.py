"""Chunked-Thomas sweep kernels (ops/sweeps.py) in Pallas interpret mode
against the ``lax.scan`` reference sweeps and against scipy; the kernel
selection by lowering platform; and the factorization plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from triflow_jax.core.compiler import bands_to_csc
from triflow_jax.ops import banded, sweeps

DTYPES = [np.float32, np.float64]
#: float32 sweeps agree with the scan to a few ulps of the (well-scaled,
#: diagonally dominant) operands; float64 to a few ulps as well
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _blocks(s, Mc, C, dtype, seed=0):
    rng = np.random.RandomState(seed)
    L = rng.randn(Mc, s, s, C)
    U = rng.randn(Mc, s, s, C)
    D = rng.randn(Mc, s, s, C) + 3.0 * (s + 2) * np.eye(s)[None, :, :, None]
    return [jnp.asarray(a, dtype) for a in (L, D, U)]


def _assert_close(got, ref, dtype):
    for g, r in zip(got, ref):
        scale = max(float(jnp.max(jnp.abs(r))), 1.0)
        assert float(jnp.max(jnp.abs(g - r))) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_factor_blocks_matches_scan(s, dtype):
    Lc, Dc, Uc = _blocks(s, 6, 8, dtype)
    got = sweeps.factor_blocks(Lc, Dc, Uc, interpret=True)
    _assert_close(got, banded._factor_scan(Lc, Dc, Uc), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_solve_matches_scan(s, dtype):
    fac, Dhinv, DU, _, _ = banded._factor_scan(*_blocks(s, 5, 4, dtype))
    b = jnp.asarray(np.random.RandomState(1).randn(5, 3, s, 4), dtype)
    got = sweeps.solve(fac, Dhinv, DU, b, interpret=True)
    _assert_close([got], [banded._solve_scan(fac, Dhinv, DU, b)], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,nvar", [(3, 1), (5, 1), (7, 1), (5, 2)])
def test_factor_bands_matches_assembly(W, nvar, dtype):
    """Fused assembly of alpha*I + beta*J inside the sweep equals XLA block
    assembly followed by the scan sweeps (s = 1, 2, 3, 4), including the
    padded rows past the last real block row."""
    h = W // 2
    g = max(h, 1)
    M, C = 29, 8
    Mc = -(-M // C)
    J = jnp.asarray(np.random.RandomState(2).randn(W, nvar, nvar, M * g),
                    dtype)
    alpha, beta = 1.0, -0.05
    Jp = jnp.pad(J, [(0, 0)] * 3 + [(0, (Mc * C - M) * g)])
    bands_c = jnp.transpose(Jp.reshape(W, nvar, nvar, C, Mc, g),
                            (4, 0, 1, 2, 5, 3))
    got = sweeps.factor_bands(bands_c, alpha, beta, M, interpret=True)
    L, D, U, *_ = banded._assemble_blocks(banded.axpy_bands(alpha, beta, J))
    Mp = Mc * C
    ref = banded._factor_scan(
        banded._to_chunks(banded._pad_rows(L, Mp), C, Mc),
        banded._to_chunks(banded._pad_rows(D, Mp, True), C, Mc),
        banded._to_chunks(banded._pad_rows(U, Mp), C, Mc))
    _assert_close(got, ref, dtype)


@pytest.fixture
def kernel_sweeps(monkeypatch):
    """Route the solver's sweeps through the kernels (interpret mode), as
    on a GPU, with small chunks so the chunked path engages at test N."""
    monkeypatch.setattr(banded, "_sweep",
                        lambda kernel, scan, *a: kernel(*a, interpret=True))
    monkeypatch.setattr(banded, "_CHUNK_MIN_M", 64)
    monkeypatch.setattr(banded, "_CHUNK_MIN_DEPTH", 8)


def _random_system(W, nvar, N, seed):
    rng = np.random.RandomState(seed)
    J = rng.randn(W, nvar, nvar, N) * 0.3
    rhs = rng.randn(nvar, N)
    return J, rhs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periodic", [True, False])
def test_kernel_solver_vs_scipy(kernel_sweeps, periodic, dtype):
    """Whole factor_linearized + Woodbury solve with the kernels in the
    loop, batched over B=3 members with jax.vmap, against scipy."""
    W, nvar, N, B = 5, 1, 2 * 150, 3
    beta = -0.1
    systems = [_random_system(W, nvar, N, seed) for seed in range(B)]
    Js = jnp.asarray(np.stack([J for J, _ in systems]), dtype)
    rhs = jnp.asarray(np.stack([r for _, r in systems]), dtype)
    x = jax.vmap(lambda J, r: banded.factor_linearized(1.0, beta, J,
                                                       periodic).solve(r))(
        Js, rhs)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    for i, (J, r) in enumerate(systems):
        A = bands_to_csc(np.asarray(banded.axpy_bands(1.0, beta, J)),
                         periodic)
        ref = spla.spsolve(A.tocsc(), r.T.flatten())
        assert np.abs(np.asarray(x[i]).T.flatten() - ref).max() < tol


def test_kernel_factor_banded_vs_scipy(kernel_sweeps):
    """Block-input kernel path (factor_banded: s = 4 supernodes, a grid
    that is not a multiple of the supernode size) against scipy."""
    W, nvar, N = 5, 2, 2 * 97 + 1
    J, r = _random_system(W, nvar, N, 5)
    A_bands = banded.axpy_bands(1.0, -0.1, J)
    x = banded.solve_banded(A_bands, r, True)
    ref = spla.spsolve(bands_to_csc(np.asarray(A_bands), True).tocsc(),
                       r.T.flatten())
    assert np.abs(np.asarray(x).T.flatten() - ref).max() < 1e-10


def _count_kernels(platform, dtype=jnp.float32):
    N = 4096
    J = jnp.zeros((5, 1, 1, N), dtype)
    r = jnp.zeros((1, N), dtype)

    def step(J, r):
        return banded.factor_linearized(1.0, -0.1, J, True).solve(r)

    text = jax.jit(step).trace(J, r).lower(
        lowering_platforms=(platform,)).as_text()
    return text.count("__gpu$xla.gpu.triton")


def test_kernel_selection_follows_platform_not_env(monkeypatch):
    """The sweeps lower to the Triton kernels exactly when the program is
    lowered for CUDA (factor, Woodbury columns, one solve), to scans for
    the CPU, and no environment variable changes that."""
    assert _count_kernels("cuda") == 3
    assert _count_kernels("cpu") == 0
    for knob in ("TRIFLOW_NO_PALLAS", "TRIFLOW_PALLAS_INTERPRET",
                 "JAX_PLATFORMS"):
        monkeypatch.setenv(knob, "1")
    assert _count_kernels("cuda") == 3
    assert _count_kernels("cpu") == 0


def test_scan_sweeps_context_lowers_no_kernel():
    with banded.scan_sweeps():
        assert _count_kernels("cuda") == 0
    assert _count_kernels("cuda") == 3


@pytest.mark.parametrize("M,C", [(1024, 32), (5000, 128), (500_000, 8192),
                                 (50_000, 1024)])
def test_pick_chunks(M, C):
    """Power-of-two chunk counts with at least _CHUNK_MIN_DEPTH rows each
    (the kernels tile chunks in power-of-two programs)."""
    got = banded._pick_chunks(M)
    assert got == C
    assert -(-M // got) >= banded._CHUNK_MIN_DEPTH


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_compiled_kernels_match_scan_on_gpu(gpu_device, dtype):
    """The kernels as compiled for the card (no interpreter) against the
    lax.scan sweeps of the same plan."""
    N = 2 * 8192
    J, r = _random_system(5, 1, N, 7)
    J = jax.device_put(jnp.asarray(J, dtype), gpu_device)
    r = jax.device_put(jnp.asarray(r, dtype), gpu_device)

    def make_solve():
        # a fresh function per version: JAX caches traces per function
        return lambda J, r: banded.factor_linearized(1.0, -0.1, J,
                                                     True).solve(r)

    x_kernel = jax.jit(make_solve())(J, r)
    with banded.scan_sweeps():
        x_scan = jax.jit(make_solve())(J, r)
    _assert_close([x_kernel], [x_scan], dtype)
