"""Fields container: a JAX-pytree state holder for the PDE unknowns.

Replaces the reference's xarray.Dataset subclass
(upstream triflow/core/fields.py:21-189) with a lightweight mapping of
named arrays registered as a JAX pytree, so the whole simulation state can be
traced through ``jit`` / ``vmap`` / ``shard_map`` without host round-trips.

API parity with the reference container:

* ``factory(coords, dependent_variables, helper_functions)`` /
  ``factory1D(dependent_variables, helper_functions)``
  (fields.py:40-105) — here they return a :class:`FieldsTemplate` callable.
* ``fields["U"]`` / ``fields["U"] = arr`` item access.
* ``fields.uflat`` — interleaved flat copy ``[U0, V0, U1, V1, ...]``
  (fields.py:147-159).
* ``fields.fill(uflat)`` — scatter a flat solver vector back (fields.py:173-183).
* ``fields.uarray``, ``fields.size``, ``fields.keys()``, ``copy()``,
  ``to_df()/to_csv()/to_clipboard()`` (fields.py:137-189).
* picklable (fields.py:114-120).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np


class FieldsTemplate:
    """Factory bound to a model's variable layout; calling it with named
    arrays yields a :class:`Fields` instance (reference analog: the
    dynamically generated ``Field`` class, fields.py:40-77)."""

    def __init__(self, coords, dependent_variables_info, helper_functions_info):
        self.coords = tuple(coords)
        self.dependent_variables_info = tuple(
            (name, tuple(dims)) for name, dims in dependent_variables_info
        )
        self.helper_functions_info = tuple(
            (name, tuple(dims)) for name, dims in helper_functions_info
        )

    @property
    def dependent_variables(self):
        return [name for name, _ in self.dependent_variables_info]

    @property
    def helper_functions(self):
        return [name for name, _ in self.helper_functions_info]

    def __call__(self, **inputs) -> "Fields":
        return Fields(self, **inputs)

    # template equality drives pytree-aux comparison, so make it structural
    def __eq__(self, other):
        return (
            isinstance(other, FieldsTemplate)
            and self.coords == other.coords
            and self.dependent_variables_info == other.dependent_variables_info
            and self.helper_functions_info == other.helper_functions_info
        )

    def __hash__(self):
        return hash(
            (self.coords, self.dependent_variables_info, self.helper_functions_info)
        )


def factory(coords, dependent_variables, helper_functions) -> FieldsTemplate:
    """Parity wrapper for BaseFields.factory (fields.py:40-77)."""
    return FieldsTemplate(coords, dependent_variables, helper_functions)


def factory1D(dependent_variables, helper_functions) -> FieldsTemplate:
    """Parity wrapper for BaseFields.factory1D (fields.py:79-105)."""
    return FieldsTemplate(
        ("x",),
        [(name, ("x",)) for name in dependent_variables],
        [(name, ("x",)) for name in helper_functions],
    )


@jax.tree_util.register_pytree_node_class
class Fields:
    """Named-array state container registered as a JAX pytree.

    Leaves are the coordinate arrays followed by every variable array, in the
    template's fixed order, so two Fields built from the same template always
    share a treedef (required for jit cache hits).
    """

    def __init__(self, template: FieldsTemplate, **inputs):
        self.template = template
        self._data: Dict[str, jnp.ndarray] = {}
        for coord in template.coords:
            if coord not in inputs:
                raise KeyError(f"missing coordinate '{coord}'")
            self._data[coord] = inputs[coord]
        for name, _dims in (
            template.dependent_variables_info + template.helper_functions_info
        ):
            if name not in inputs:
                raise KeyError(f"missing variable '{name}'")
            self._data[name] = inputs[name]

    # -- mapping interface -------------------------------------------------
    def keys(self):
        return [*self.template.coords, *self._var_names()]

    def _var_names(self):
        return [
            name
            for name, _ in (
                self.template.dependent_variables_info
                + self.template.helper_functions_info
            )
        ]

    @property
    def dependent_variables(self):
        return self.template.dependent_variables

    @property
    def helper_functions(self):
        return self.template.helper_functions

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        if key not in self._data:
            raise KeyError(
                f"unknown field '{key}' (template fields: {self.keys()})"
            )
        self._data[key] = value

    def __contains__(self, key):
        return key in self._data

    def __iter__(self):
        return iter(self.keys())

    def __repr__(self):
        lines = ["Fields:"]
        for key in self.keys():
            arr = self._data[key]
            lines.append(f"  {key}: shape={tuple(np.shape(arr))}")
        return "\n".join(lines)

    # -- pytree protocol -----------------------------------------------------
    def tree_flatten(self):
        leaves = [self._data[k] for k in self.keys()]
        return leaves, self.template

    @classmethod
    def tree_unflatten(cls, template, leaves):
        obj = cls.__new__(cls)
        obj.template = template
        names = [*template.coords]
        names += [
            name
            for name, _ in (
                template.dependent_variables_info + template.helper_functions_info
            )
        ]
        obj._data = dict(zip(names, leaves))
        return obj

    # pickling rides the pytree protocol
    def __reduce__(self):
        leaves, template = self.tree_flatten()
        return (
            _rebuild_fields,
            (template, [np.asarray(leaf) for leaf in leaves]),
        )

    # -- numerics interface --------------------------------------------------
    @property
    def size(self) -> int:
        """Number of nodes along the primary coordinate (fields.py:137-140)."""
        return int(np.shape(self._data[self.template.coords[0]])[0])

    def _node_components(self, name, dims):
        """Per-node component count of a variable (1 for 1D vars; the product
        of the non-primary coordinate sizes otherwise)."""
        comps = 1
        for dim in dims:
            if dim != self.template.coords[0]:
                comps *= int(np.shape(self._data[dim])[0])
        return comps

    @property
    def uarray(self):
        """Dependent variables stacked as (nvar, N) (device array)."""
        return jnp.stack(
            [jnp.asarray(self._data[name]) for name in self.dependent_variables]
        )

    @property
    def uflat(self):
        """Interleaved flat **copy** of the dependent variables,
        ``[U0, V0, U1, V1, ...]`` — node-major, matching the reference's
        Fortran flatten (fields.py:147-159)."""
        cols = []
        x_name = self.template.coords[0]
        N = self.size
        for name, dims in self.template.dependent_variables_info:
            arr = jnp.asarray(self._data[name])
            if arr.ndim == 1:
                cols.append(arr[:, None])
            else:
                cols.append(arr.reshape(N, -1))
        return jnp.concatenate(cols, axis=1).ravel()

    def fill(self, uflat):
        """Scatter a flat interleaved solver vector back into the variables
        (fields.py:173-183).

        Host-side, mutating: rebinds ``self``'s per-variable arrays (the
        scipy_ode/duck-typed path's workspace update).  Do NOT call from
        traced code — a traced caller would silently alias stale values;
        use :meth:`assign` (functional) or ``filled`` instead."""
        uflat = jnp.asarray(uflat)
        N = self.size
        rarray = uflat.reshape(N, -1)
        ptr = 0
        for name, dims in self.template.dependent_variables_info:
            comps = self._node_components(name, dims)
            chunk = rarray[:, ptr : ptr + comps]
            target_shape = np.shape(self._data[name])
            self._data[name] = chunk.reshape(target_shape)
            ptr += comps

    def filled(self, uflat) -> "Fields":
        """Functional twin of :meth:`fill`: a NEW Fields with the flat
        interleaved vector scattered into the variables (trace-safe)."""
        new = self.copy(deep=False)
        new.fill(uflat)
        return new

    def assign(self, **updates) -> "Fields":
        """Functional update: return a new Fields with replaced arrays."""
        new = self.copy(deep=False)
        for key, value in updates.items():
            new[key] = value
        return new

    def copy(self, deep: bool = True) -> "Fields":
        leaves, template = self.tree_flatten()
        if deep:
            leaves = [
                np.array(leaf) if isinstance(leaf, np.ndarray) else leaf
                for leaf in leaves
            ]
        return Fields.tree_unflatten(template, list(leaves))

    def __copy__(self):
        return self.copy(deep=False)

    def __deepcopy__(self, memo):
        return self.copy(deep=True)

    # -- export ---------------------------------------------------------------
    def to_df(self):
        import pandas as pd

        if len(self.template.coords) > 1:
            raise ValueError("CSV files only available for 1D arrays")
        x_name = self.template.coords[0]
        data = {key: np.asarray(self._data[key]) for key in self._var_names()}
        return pd.DataFrame(data, index=np.asarray(self._data[x_name]))

    def to_csv(self, path):
        self.to_df().to_csv(path)

    def to_clipboard(self):
        self.to_df().to_clipboard()


def _rebuild_fields(template, leaves):
    return Fields.tree_unflatten(template, leaves)
