"""Reference-compatible import paths and converter semantics."""

import importlib
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

_ROOT = Path(__file__).resolve().parents[1]


def _former_names():
    """Packages at the repository root that alias stein_jax under a
    former import name (their __init__ says so)."""
    return sorted(d.name for d in _ROOT.iterdir()
                  if (d / "__init__.py").is_file()
                  and "Former import name" in (d / "__init__.py").read_text())


@pytest.mark.parametrize("sub", ["", ".api", ".ops.rbf", ".ops.pallas_svgd",
                                 ".parallel.sharded", ".models"])
def test_former_import_name_is_stein_jax(sub):
    """Code written against the package's former name keeps working: its
    modules are stein_jax's own module objects, not copies."""
    names = _former_names()
    assert names
    for name in names:
        assert (importlib.import_module(name + sub)
                is importlib.import_module("stein_jax" + sub))


def test_reference_import_paths():
    from stein_jax.samplers import SteinSampler
    from stein_jax.optimizers import (
        AdamGradientDescent, AdagradGradientDescent,
    )
    from stein_jax.kernels import SquaredExponentialKernel
    from stein_jax.utilities import (
        convert_dictionary_to_array, convert_array_to_dictionary,
        compute_median,
    )
    assert SteinSampler is not None
    assert AdamGradientDescent(learning_rate=0.1).learning_rate == 0.1
    assert AdagradGradientDescent().alpha == 0.9
    assert SquaredExponentialKernel() is not None
    assert callable(convert_dictionary_to_array)
    assert callable(convert_array_to_dictionary)
    assert callable(compute_median)


def test_converters_roundtrip_sorted_layout():
    from stein_jax.utilities import (
        convert_dictionary_to_array, convert_array_to_dictionary,
    )
    rng = np.random.default_rng(0)
    n = 5
    d = {
        "b_weights": rng.normal(size=(n, 2, 3)),
        "a_bias": rng.normal(size=(n, 4)),
        "c_scalar": rng.normal(size=(n,)),
    }
    arr, idx = convert_dictionary_to_array(d)
    assert arr.shape == (n, 6 + 4 + 1)
    # Sorted-key layout (reference converters.py:40): a_bias first.
    assert idx["a_bias"] == (0, 4)
    assert idx["b_weights"] == (4, 10)
    assert idx["c_scalar"] == (10, 11)
    np.testing.assert_allclose(
        np.asarray(arr[:, 0:4]), d["a_bias"]
    )
    back = convert_array_to_dictionary(
        arr, idx, {"a_bias": (4,), "b_weights": (2, 3), "c_scalar": ()}
    )
    for k in d:
        np.testing.assert_allclose(np.asarray(back[k]), d[k])


def test_compute_median_alias():
    from stein_jax.utilities import compute_median
    x = jnp.asarray([3.0, 1.0, 2.0, 10.0])
    assert float(compute_median(x)) == 2.5


def test_save_restore_without_npz_suffix(tmp_path):
    import jax, numpy as np
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 2)); y = X @ rng.normal(size=(2, 1))
    model = LinearRegressionModel(2)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    s = SVGDSampler(8, model.log_p, model.template(jnp.float64),
                    Adam(learning_rate=1e-1), key=jax.random.PRNGKey(0),
                    dtype=jnp.float64)
    s.train_on_batch(batch)
    path = str(tmp_path / "ckpt")       # no extension
    s.save(path)
    import os
    assert os.path.exists(path)
    s.restore(path)
    assert int(s.state.step) == 1


def test_donate_false_keeps_state_references():
    import jax, numpy as np
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel
    rng = np.random.default_rng(1)
    X = rng.normal(size=(20, 2)); y = X @ rng.normal(size=(2, 1))
    model = LinearRegressionModel(2)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    s = SVGDSampler(8, model.log_p, model.template(jnp.float64),
                    Adam(learning_rate=1e-1), key=jax.random.PRNGKey(0),
                    dtype=jnp.float64, donate=False)
    p0 = s.state.particles
    s.run(batch, 3)
    s.train_on_batches({"X": jnp.asarray(X)[None], "y": jnp.asarray(y)[None]})
    np.asarray(p0)  # must still be alive — donation was opted out


def test_option_guards():
    import pytest, jax
    from stein_jax import SVGDSampler, Adam, InverseMultiquadricKernel
    from stein_jax.models import LinearRegressionModel
    from stein_jax.parallel import particle_mesh
    model = LinearRegressionModel(2)
    common = dict(n_particles=8, log_p=model.log_p,
                  param_template=model.template(jnp.float64),
                  gd=Adam(), dtype=jnp.float64)
    # pallas + exact median would materialise the n^2 matrix: refuse.
    with pytest.raises(ValueError):
        SVGDSampler(kernel_impl="pallas", median="exact", **common)
    mesh = particle_mesh(jax.devices()[:1])
    # Both 1-D and 2-D meshes honour custom kernels since r2 (generic
    # weights tile; equality tests in test_sharded.py / test_sharded2d.py).
    # A 2-D mesh still refuses median modes its tiled path cannot honour.
    import numpy as _np
    from jax.sharding import Mesh
    mesh2d = Mesh(_np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("particles", "model"))
    with pytest.raises(ValueError, match="2-D sharded median"):
        SVGDSampler(mesh=mesh2d, model_axis="model", median="subsample",
                    kernel=InverseMultiquadricKernel(), **common)
    with pytest.raises(ValueError):
        SVGDSampler(mesh=mesh, kernel_impl="pallas", **common)


import pytest as _pytest


@_pytest.mark.usefixtures("eight_devices")
def test_mesh_remat_matches_plain():
    import jax, numpy as np
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel
    from stein_jax.parallel import particle_mesh
    rng = np.random.default_rng(2)
    X = rng.normal(size=(20, 2)); y = X @ rng.normal(size=(2, 1))
    model = LinearRegressionModel(2)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    mesh = particle_mesh(jax.devices()[:8])
    theta0 = jnp.asarray(rng.normal(size=(16, 2)) * 0.01)
    def make(remat):
        return SVGDSampler(16, model.log_p, model.template(jnp.float64),
                           Adam(learning_rate=1e-1), theta=theta0,
                           dtype=jnp.float64, mesh=mesh, remat=remat)
    a, b = make(False), make(True)
    for _ in range(3):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_array_equal(a.samples, b.samples)
