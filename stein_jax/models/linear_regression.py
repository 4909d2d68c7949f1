"""Bayesian linear regression model.

Same probabilistic model as the reference example
(examples/linear_regression/main.py:18-31): N(0,1) prior on the weights and a
unit-variance Gaussian likelihood,
  log_p = -0.5 * sum((Xw - y)^2) + sum log N(w; 0, 1),
expressed as a pure function of a parameter pytree instead of a TF graph.
"""

import dataclasses

import jax
import jax.numpy as jnp

from .distributions import normal_log_prob, resolve_precision

# Data matmuls run at the precision named by ``precision`` (see
# distributions.resolve_precision); the reference's TF1 graph ran them
# in f32.


@dataclasses.dataclass(frozen=True)
class LinearRegressionModel:
    n_feats: int
    precision: str = "high"

    @property
    def _prec(self):
        return resolve_precision(self.precision)

    def template(self, dtype=jnp.float32):
        return {"w": jnp.zeros((self.n_feats, 1), dtype)}

    def predict(self, params, batch):
        return jnp.matmul(batch["X"], params["w"], precision=self._prec)

    def sufficient_batch(self, batch, dtype=jnp.float32):
        """Precompute the Gaussian model's sufficient statistics
        A = X^T X, b = X^T y, yty = y^T y once, so every SVGD step's
        per-particle likelihood costs O(p^2) instead of O(n_obs * p):
        -0.5 ||Xw - y||^2 = -0.5 (w^T A w - 2 b^T w + yty) exactly.
        The reference's own example re-multiplies the SAME full batch
        through the graph every one of its 500 iterations
        (examples/linear_regression/main.py:42-48) — for full-batch
        training this is pure algebra, not an approximation (the
        statistics are computed at HIGHEST precision so no f32 digits
        are lost in the reduction). Feed the returned dict to
        train_on_batch / run in place of {"X", "y"}; log_p dispatches
        on the keys."""
        X = jnp.asarray(batch["X"], dtype)
        y = jnp.asarray(batch["y"], dtype)
        hi = jax.lax.Precision.HIGHEST
        return {
            "A": jnp.matmul(X.T, X, precision=hi),
            "b": jnp.matmul(X.T, y, precision=hi),
            "yty": jnp.sum(y * y),
        }

    def log_p(self, params, batch):
        w = params["w"]
        if "A" in batch:
            Aw = jnp.matmul(batch["A"], w, precision=self._prec)
            log_l = -0.5 * (
                jnp.sum(w * Aw) - 2.0 * jnp.sum(batch["b"] * w)
                + batch["yty"]
            )
        else:
            y_hat = jnp.matmul(batch["X"], w, precision=self._prec)
            log_l = -0.5 * jnp.sum(jnp.square(y_hat - batch["y"]))
        log_prior = jnp.sum(normal_log_prob(w, 0.0, 1.0))
        return log_l + log_prior
