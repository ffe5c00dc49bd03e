"""The port's Keras h5 import (``models/keras_import.py``) against the JAX package's.

The seeded Keras-faithful didbl fixture of tests/test_keras_import_golden.py
(topological layer order, weightless layers interleaved) imports to JAX's
tree leaf for leaf, and the port's float32 forward over it reproduces the
committed golden activations (tests/golden/didbl96_golden.npz) within that
test's 1e-3.  Round trips through random h5 files cover every family.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models import get_model as jax_get_model
from image_enhance_keras_tpu.models import init_params as jax_init_params
from image_enhance_keras_tpu.models import keras_import as jax_ki
from image_enhance_keras_tpu_torch.engine import SuperResolver
from image_enhance_keras_tpu_torch.models import keras_import as ki
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.weights import flatten_params, load_params, params_of_module
from tests.test_keras_import_golden import GOLDEN, _write_keras_faithful_h5
from tests.test_models import _write_fake_keras_h5

#: reduced block counts of each family (round trips)
COUNTS = {"didbl": dict(n_body53=2, n_light=1, n_tail53=1), "didbl_subpixel": dict(n_body53=1, n_light=1, n_tail53=1),
          "difv4": dict(n_head=1, n_mid=2, n_tail=1), "difvdsr": dict(n_blocks=2)}


@pytest.mark.parametrize("convention", ["topo", "creation"])
@pytest.mark.parametrize("name", sorted(COUNTS))
def test_conv_order_matches_jax(name, convention):
    for counts in ({}, COUNTS[name]):
        assert ki.keras_conv_order(name, convention=convention, **counts) == \
            jax_ki.keras_conv_order(name, convention=convention, **counts)
    with pytest.raises(KeyError):
        ki.keras_conv_order("difv4_x2")
    with pytest.raises(ValueError, match="convention"):
        ki.keras_conv_order(name, convention="alphabetical")


@pytest.fixture(scope="module")
def faithful(tmp_path_factory):
    """The full-size Keras-faithful didbl file (seed 2), JAX's and the port's imports of it."""
    path = str(tmp_path_factory.mktemp("h5") / "didbl_full.h5")
    _write_keras_faithful_h5(path)
    jmod, _ = jax_get_model("didbl")
    want = jax_ki.import_keras_weights(path, "didbl", jax_init_params(jmod, input_hw=(8, 8)))
    mod, _ = port_zoo.get_model("didbl")
    got = ki.import_keras_weights(path, "didbl", params_of_module(mod))
    return path, want, got, mod


def test_faithful_fixture_tree_matches_jax_leaf_for_leaf(faithful):
    _, want, got, _ = faithful
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want))
    got = flatten_params(got)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_faithful_fixture_reproduces_the_golden(faithful):
    """h5 -> tree -> the port's float32 forward on a 96^2 tile: the committed golden."""
    _, _, got, mod = faithful
    load_params(mod, got)
    x = np.random.default_rng(3).integers(0, 256, (1, 96, 96, 3)).astype(np.float32) / 255.0
    with torch.no_grad():
        y = mod(torch.from_numpy(x)).numpy()
    assert y.shape == (1, 384, 384, 3)
    g = np.load(GOLDEN)
    np.testing.assert_allclose(y[0, ::16, ::16, :], g["slice"], atol=1e-3)
    assert abs(float(np.mean(y)) - float(g["mean"])) < 1e-4


def test_root_layout_imports_the_same_tree(tmp_path):
    """``save_weights`` writes the layer groups at the file root."""
    mod, _ = port_zoo.get_model("didbl", **{"features": 8, **COUNTS["didbl"]})
    paths = [str(tmp_path / "wrapped.h5"), str(tmp_path / "root.h5")]
    _write_keras_faithful_h5(paths[0], seed=9, features=8, **COUNTS["didbl"])
    _write_keras_faithful_h5(paths[1], seed=9, root_layout=True, features=8, **COUNTS["didbl"])
    a, b = (flatten_params(ki.import_keras_weights(p, "didbl", params_of_module(mod), **COUNTS["didbl"]))
            for p in paths)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_round_trip(tmp_path, name):
    """Random conv weights in a Keras-layout file land at keras_conv_order's
    paths, as JAX's importer puts them, and the module runs on them."""
    counts = COUNTS[name]
    mod, _ = port_zoo.get_model(name, features=16, **counts)
    params = params_of_module(mod)
    order = ki.keras_conv_order(name, **counts)
    shapes = [tuple(_node(params, keys)["kernel"].shape) for keys in order]
    path = str(tmp_path / f"{name}.h5")
    weights = _write_fake_keras_h5(path, shapes)
    got = ki.import_keras_weights(path, name, params, **counts)
    for (k, b), keys in zip(weights, order):
        np.testing.assert_array_equal(_node(got, keys)["kernel"], k)
        np.testing.assert_array_equal(_node(got, keys)["bias"], b)
    want = jax_ki.import_keras_weights(path, name, jax.tree_util.tree_map(lambda t: t.numpy(), params), **counts)
    for k, w in flatten_params(jax.tree_util.tree_map(np.asarray, want)).items():
        np.testing.assert_array_equal(np.asarray(flatten_params(got)[k]), w, err_msg=k)
    load_params(mod, got)
    with torch.no_grad():
        assert torch.isfinite(mod(torch.zeros(1, 8, 8, 3))).all()


def test_mismatches_raise(tmp_path):
    mod, _ = port_zoo.get_model("difvdsr", features=16, **COUNTS["difvdsr"])
    n = len(ki.keras_conv_order("difvdsr", **COUNTS["difvdsr"]))
    path = str(tmp_path / "bad.h5")
    _write_fake_keras_h5(path, [(3, 3, 3, 7)] * n)
    with pytest.raises(ValueError, match="shape mismatch"):
        ki.import_keras_weights(path, "difvdsr", params_of_module(mod), **COUNTS["difvdsr"])
    with pytest.raises(ValueError, match="conv layers"):
        ki.import_keras_weights(path, "difvdsr", params_of_module(mod))


def test_engine_loads_h5(tmp_path, monkeypatch):
    """``SuperResolver(weights=...h5)`` imports by the model's name."""
    counts = COUNTS["difv4"]
    mod, spec = port_zoo.get_model("difv4", features=16, **counts)
    order = ki.keras_conv_order("difv4", **counts)
    shapes = [tuple(_node(params_of_module(mod), keys)["kernel"].shape) for keys in order]
    path = str(tmp_path / "difv4.h5")
    weights = _write_fake_keras_h5(path, shapes)
    full_order = ki.keras_conv_order
    monkeypatch.setattr(ki, "keras_conv_order", lambda name, **kw: full_order(name, **{**counts, **kw}))
    r = SuperResolver(model="difv4", module_and_spec=(mod, spec), weights=path, device="cpu")
    np.testing.assert_array_equal(r.params["mid_1"]["conv_b"]["kernel"].numpy(),
                                  weights[order.index(("mid_1", "conv_b"))][0])
    with pytest.raises(NotImplementedError, match="orbax"):
        r.load_weights(str(tmp_path))


def test_missing_h5py_raises_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs the h5py package"):
        ki.load_keras_h5(os.path.join(str(tmp_path), "any.h5"))
