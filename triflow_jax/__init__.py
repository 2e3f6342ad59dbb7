"""triflow-jax: automatic finite-difference discretization for 1D
PDE systems with fast implicit temporal solvers.

A ground-up JAX/XLA rebuild with the capabilities of triflow
(reference surface: upstream triflow/__init__.py:1-18).
"""

import logging
from logging import NullHandler

from .core import schemes  # noqa
from .core.model import Model  # noqa
from .core.fields import Fields, factory, factory1D  # noqa
from .core.simulation import Simulation  # noqa

from .plugins.container import Container  # noqa
from .plugins.displays import Display  # noqa

logging.getLogger(__name__).addHandler(NullHandler())

retrieve_container = Container.retrieve
display_fields = Display.display_fields
display_probe = Display.display_probe

__version__ = "0.1.0"

__all__ = [
    "Model",
    "Simulation",
    "schemes",
    "Container",
    "Display",
    "Fields",
    "factory",
    "factory1D",
    "retrieve_container",
    "display_fields",
    "display_probe",
]
