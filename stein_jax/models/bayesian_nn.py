"""Bayesian neural-network regression (1-hidden-layer ReLU MLP).

Same probabilistic model as the reference example
(examples/regression_neural_network/main.py:29-85): Gamma(1, 0.01) priors on
the weight precision lambda = exp(log_lambda) and noise precision
gamma = exp(log_gamma) (evaluated at the exp'd values with no Jacobian
correction, as the reference does), N(0, lambda^-1/2) priors on all weights
and biases, Gaussian likelihood with scale gamma^-1/2, the log-likelihood
rescaled by n_train/n_batch, and the whole log-posterior divided by n_train.
"""

import dataclasses
import math

import jax.numpy as jnp

from .distributions import (
    normal_log_prob,
    gamma_log_prob,
    resolve_precision,
)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class BayesianNNModel:
    n_feats: int
    n_hidden: int
    n_train: int
    n_batch: int
    prior_alpha: float = 1.0
    prior_beta: float = 0.01
    # Data-matmul precision by name (see distributions.resolve_precision).
    precision: str = "high"

    @property
    def _prec(self):
        return resolve_precision(self.precision)

    def template(self, dtype=jnp.float32):
        return {
            "log_lambda": jnp.zeros((), dtype),
            "log_gamma": jnp.zeros((), dtype),
            "w_1": jnp.zeros((self.n_feats, self.n_hidden), dtype),
            "b_1": jnp.zeros((self.n_hidden,), dtype),
            "w_2": jnp.zeros((self.n_hidden, 1), dtype),
            "b_2": jnp.zeros((), dtype),
        }

    def predict(self, params, batch):
        h = jnp.maximum(
            jnp.matmul(batch["X"], params["w_1"], precision=self._prec)
            + params["b_1"], 0.0,
        )
        return (jnp.matmul(h, params["w_2"], precision=self._prec)
                + params["b_2"])

    def log_p(self, params, batch):
        lam = jnp.exp(params["log_lambda"])
        gam = jnp.exp(params["log_gamma"])
        pred = self.predict(params, batch)
        log_l = jnp.sum(
            normal_log_prob(batch["y"], pred, 1.0 / jnp.sqrt(gam))
        )
        prior_scale = 1.0 / jnp.sqrt(lam)
        log_prior = (
            gamma_log_prob(lam, self.prior_alpha, self.prior_beta)
            + gamma_log_prob(gam, self.prior_alpha, self.prior_beta)
            + jnp.sum(normal_log_prob(params["w_1"], 0.0, prior_scale))
            + jnp.sum(normal_log_prob(params["w_2"], 0.0, prior_scale))
            + jnp.sum(normal_log_prob(params["b_1"], 0.0, prior_scale))
            + normal_log_prob(params["b_2"], 0.0, prior_scale)
        )
        scale = self.n_train / self.n_batch
        return (log_l * scale + log_prior) / self.n_train
