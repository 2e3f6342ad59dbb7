"""Runnable-docs policy (the reference runs its RST doctests in CI,
Makefile:20): execute the >>> examples embedded in the public docstrings."""

import doctest

import triflow_jax
import triflow_jax.core.model
import triflow_jax.core.simulation


def _run(module):
    results = doctest.testmod(
        module, optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE,
        verbose=False,
    )
    assert results.failed == 0, f"{results.failed} doctest failures in {module}"
    return results


def test_model_doctests():
    results = _run(triflow_jax.core.model)
    assert results.attempted >= 2


def test_simulation_doctests():
    results = _run(triflow_jax.core.simulation)
    assert results.attempted >= 5
