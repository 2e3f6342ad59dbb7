"""Fields container semantics (mirrors upstream tests/test_fields.py):
template/factory equivalence, uflat interleaving, fill roundtrip, pickle/copy,
CSV export, 2D export rejection — plus pytree registration checks specific to
the JAX rebuild."""

import pickle

import jax
import numpy as np
import pytest

from triflow_jax import Model, factory, factory1D


@pytest.fixture
def fields2():
    model = Model(["dxxU", "dxxV"], ["U", "V"], help_functions="s")
    x = np.linspace(0, 10, 50, endpoint=False)
    U = np.cos(x)
    V = np.sin(x)
    s = np.zeros_like(x)
    return model.fields_template(x=x, U=U, V=V, s=s)


def test_template_matches_factory(fields2):
    template = factory1D(["U", "V"], ["s"])
    x = np.asarray(fields2["x"])
    direct = template(x=x, U=np.asarray(fields2["U"]),
                      V=np.asarray(fields2["V"]), s=np.asarray(fields2["s"]))
    assert direct.keys() == fields2.keys()
    assert np.allclose(direct.uflat, fields2.uflat)


def test_uflat_interleaving(fields2):
    """uflat must be node-major interleaved [U0, V0, U1, V1, ...]
    (reference fields.py:147-159)."""
    U = np.asarray(fields2["U"])
    V = np.asarray(fields2["V"])
    flat = np.asarray(fields2.uflat)
    assert flat.size == 2 * U.size
    assert np.allclose(flat[0::2], U)
    assert np.allclose(flat[1::2], V)


def test_fill_roundtrip(fields2):
    flat = np.asarray(fields2.uflat)
    other = fields2.copy()
    other["U"] = np.zeros_like(np.asarray(fields2["U"]))
    other.fill(flat)
    assert np.allclose(other["U"], fields2["U"])
    assert np.allclose(other["V"], fields2["V"])


def test_missing_input_raises():
    template = factory1D(["U"], [])
    with pytest.raises(KeyError):
        template(x=np.arange(5))


def test_pickle_and_copy(fields2):
    clone = pickle.loads(pickle.dumps(fields2))
    assert clone.keys() == fields2.keys()
    assert np.allclose(clone.uflat, fields2.uflat)
    shallow = fields2.copy(deep=False)
    deep = fields2.copy(deep=True)
    assert np.allclose(np.asarray(shallow["U"]), np.asarray(deep["U"]))


def test_csv_export(fields2, tmp_path):
    path = tmp_path / "out.csv"
    fields2.to_csv(str(path))
    assert path.exists()
    df = fields2.to_df()
    assert list(df.columns) == ["U", "V", "s"]


def test_2d_export_rejected():
    template = factory(("x", "y"), [("U", ("x", "y"))], [])
    U = np.zeros((4, 3))
    f = template(x=np.arange(4), y=np.arange(3), U=U)
    with pytest.raises(ValueError):
        f.to_df()


def test_2d_uflat_fill():
    """ND duck-typed models (reference manual_2D_model.ipynb path): uflat and
    fill must roundtrip multi-coordinate variables."""
    template = factory(("x", "y"), [("h", ("x", "y")), ("q", ("x", "y"))], [])
    rng = np.random.RandomState(1)
    h = rng.randn(4, 3)
    q = rng.randn(4, 3)
    f = template(x=np.arange(4), y=np.arange(3), h=h, q=q)
    flat = np.asarray(f.uflat)
    assert flat.size == 24
    g = f.copy()
    g["h"] = np.zeros_like(h)
    g["q"] = np.zeros_like(q)
    g.fill(flat)
    assert np.allclose(g["h"], h)
    assert np.allclose(g["q"], q)


def test_pytree_roundtrip(fields2):
    """Fields must traverse jit/tree boundaries unchanged."""
    leaves, treedef = jax.tree_util.tree_flatten(fields2)
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert rebuilt.keys() == fields2.keys()

    @jax.jit
    def double_U(f):
        return f.assign(U=f["U"] * 2)

    out = double_U(fields2)
    assert np.allclose(np.asarray(out["U"]), 2 * np.asarray(fields2["U"]))
    assert np.allclose(np.asarray(out["V"]), np.asarray(fields2["V"]))
