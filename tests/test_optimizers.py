"""Optimizer step rules vs the NumPy oracle, including the reference quirks:
first-iteration moment init, bias correction from t=1, Adam's multiplicative
lr decay, and Adagrad's absence of lr decay."""

import numpy as np
import jax.numpy as jnp

from baselines.numpy_svgd import NumpyAdam, NumpyAdagrad
from stein_jax.ops.optimizers import Adam, Adagrad


def _run_both(jax_opt, np_opt, n_steps=5, shape=(6, 4), seed=0):
    rng = np.random.default_rng(seed)
    state = jax_opt.init(shape, jnp.float64)
    for t in range(n_steps):
        phi = rng.normal(size=shape)
        step_np = np_opt.update(phi)
        step_jax, state = jax_opt.update(state, jnp.asarray(phi))
        np.testing.assert_allclose(
            np.asarray(step_jax), step_np, rtol=1e-12,
            err_msg=f"step {t}"
        )
    return state


def test_adam_matches_oracle():
    _run_both(
        Adam(learning_rate=1e-1, decay=0.999),
        NumpyAdam(learning_rate=1e-1, decay=0.999),
        n_steps=7,
    )


def test_adam_no_decay():
    _run_both(Adam(learning_rate=1e-2), NumpyAdam(learning_rate=1e-2))


def test_adam_first_step_quirk():
    """First step: mu=phi, nu=phi^2, bias correction still applied =>
    step = lr * (phi/(1-b1)) / (1e-8 + sqrt(phi^2/(1-b2)))."""
    opt = Adam(learning_rate=0.1, beta_1=0.9, beta_2=0.999)
    state = opt.init((2, 2), jnp.float64)
    phi = jnp.asarray([[1.0, -2.0], [0.5, 4.0]], jnp.float64)
    step, state = opt.update(state, phi)
    mup = phi / (1 - 0.9)
    nup = phi ** 2 / (1 - 0.999)
    expect = mup / (1e-8 + jnp.sqrt(nup)) * 0.1
    np.testing.assert_allclose(np.asarray(step), np.asarray(expect), rtol=1e-12)
    assert int(state.count) == 1


def test_adagrad_matches_oracle():
    _run_both(
        Adagrad(learning_rate=1e-1, alpha=0.9),
        NumpyAdagrad(learning_rate=1e-1, alpha=0.9),
        n_steps=7,
    )


def test_adagrad_never_decays_lr():
    """Reference quirk: AdagradGradientDescent.update never applies decay
    (adagrad_gradient_descent.py:34-44)."""
    opt = Adagrad(learning_rate=0.1, decay=0.5)
    state = opt.init((2, 2), jnp.float64)
    for _ in range(3):
        _, state = opt.update(state, jnp.ones((2, 2), jnp.float64))
    assert float(state.learning_rate) == 0.1


def test_adam_decays_lr_after_step():
    opt = Adam(learning_rate=0.1, decay=0.9)
    state = opt.init((2, 2), jnp.float64)
    _, state = opt.update(state, jnp.ones((2, 2), jnp.float64))
    np.testing.assert_allclose(float(state.learning_rate), 0.09)
