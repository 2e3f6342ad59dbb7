"""Host-facing routine wrappers around the compiled backends.

API parity with upstream triflow/core/routines.py:8-91: callables
taking a Fields container and a parameter dict (including the ``periodic``
key) and returning the interleaved flat RHS (F_Routine) or a scipy CSC
Jacobian (J_Routine), plus the brute-force ``diff_approx`` dense-Jacobian
oracle (routines.py:47-61).
"""

from __future__ import annotations

import numpy as np
import sympy as sp

from .compiler import bands_to_csc


class ModelRoutine:
    def __init__(self, matrix, args, pars, backend):
        self.pars = list(pars) + ["periodic"]
        self.matrix = matrix
        self.args = args
        self._backend = backend

    def _prepare(self, fields, pars):
        backend = self._backend
        u, helpers, x = backend.split_fields(fields)
        pstack = backend.pack_pars(pars, x)
        periodic = bool(pars["periodic"])
        return u, helpers, pstack, x, periodic

    def __repr__(self):
        return sp.Matrix(np.atleast_1d(self.matrix).tolist()).__repr__()


class F_Routine(ModelRoutine):
    """Compute the RHS of the dynamical system as an interleaved flat vector
    ``[F_U(0), F_V(0), F_U(1), ...]`` (parity: routines.py:19-45)."""

    def __call__(self, fields, pars):
        u, helpers, pstack, x, periodic = self._prepare(fields, pars)
        F = self._backend.F(u, helpers, pstack, x, periodic=periodic)
        return np.asarray(F).T.flatten()

    def diff_approx(self, fields, pars, eps=1e-8):
        """Brute-force dense finite-difference Jacobian (oracle only;
        parity: routines.py:47-61 which uses eps=1E-3 — we default tighter
        since the backends run in float64)."""
        nvar = len(fields.dependent_variables)
        N = fields.size
        U = np.asarray(fields.uflat, dtype=np.float64)
        J = np.zeros((U.size, U.size))
        F0 = np.asarray(self(fields, pars), dtype=np.float64)
        for i in range(U.size):
            fields_plus = fields.copy()
            Up = np.array(U)
            Up[i] += eps
            fields_plus.fill(Up)
            Fplus = np.asarray(self(fields_plus, pars), dtype=np.float64)
            J[i] = (Fplus - F0) / eps
        return J.T


class J_Routine(ModelRoutine):
    """Compute the Jacobian as scipy CSC (sparse=True) or dense ndarray
    (parity: routines.py:64-91)."""

    def __call__(self, fields, pars, sparse=True):
        u, helpers, pstack, x, periodic = self._prepare(fields, pars)
        bands = self._backend.J_bands(u, helpers, pstack, x, periodic=periodic)
        J = bands_to_csc(np.asarray(bands), periodic)
        return J if sparse else J.todense()
