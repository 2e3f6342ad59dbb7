"""Compensated (Kahan/Neumaier) state accumulation for long time loops.

Method-of-lines trajectories accumulate one state update per internal step;
in f32 the rounding of ``u + du`` grows like sqrt(nsteps) * eps * |u| and
dominates the achievable f32 trajectory accuracy (SURVEY.md §7 hard
part 5).  Carrying a compensation array ``c`` (the rounding residual of
every past addition) removes that growth: the accumulated state behaves as
if summed in roughly twice the working precision, for 4 elementwise ops per
step and one extra carry array.

XLA does not reassociate floating-point expressions by default, so the
error-recovery identity below survives compilation.

Used by the adaptive while_loop controllers and the device_steps /
Ensemble scans when a scheme is constructed with ``compensated=True``.
"""

from __future__ import annotations


def kahan_update(u, c, u_new):
    """Fold the step update ``u_new - u`` into the compensated pair (u, c).

    Returns ``(u2, c2)`` where ``u2 = fl(u + du + c)`` and ``c2`` is the
    exactly-representable rounding residual of that addition (Neumaier's
    variant of Kahan summation, safe for |du| > |u|)."""
    du = u_new - u
    y = du + c
    u2 = u + y
    c2 = y - (u2 - u)
    return u2, c2
