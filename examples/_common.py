"""Shared helpers for the example scripts: run on CPU float64 by default
(pass --device to use the default accelerator in float32)."""

import os
import sys

# allow running the examples straight from a source checkout
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def setup(argv=None):
    argv = sys.argv if argv is None else argv
    import jax

    if "--device" not in argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    return "--device" in argv
