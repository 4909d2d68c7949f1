"""Pure-functional step rules matching the reference optimizers exactly.

The reference's optimizers (stein/optimizers/) mutate Python attributes on
host; here each rule is a pure (state, phi) -> (step, state) function whose
state is a pytree carried through the jitted SVGD step — scan-compatible,
checkpointable, and shardable along the particle axis.

Reproduced quirks (see SURVEY.md §2 #6/#7):

- Adam (adam_gradient_descent.py:41-58): first-iteration moments initialise to
  mu=phi, nu=phi^2 (not zero) while bias correction is *still* applied; the
  learning rate decays multiplicatively after every step.
- Adagrad (adagrad_gradient_descent.py:34-44): RMSProp-style decayed
  squared-gradient history with first-iteration hist=phi^2, epsilon 1e-6, and
  — unlike Adam — no learning-rate decay applied inside update.
"""

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp


def _scalar_dtype(dtype):
    """The dtype for an optimizer's scalar state and internal arithmetic:
    at least f32. Sub-f32 particle dtypes (bfloat16) cannot represent the step rules' constants (0.999 rounds to
    exactly 1.0 in bf16) or sustain a multiplicative lr decay (the
    product rounds back to the old value), so scalars/bias corrections
    compute at f32 and only the [n, p] state re-rounds to the particle
    dtype. For f32/f64 this is the identity — the oracle-pinned golden
    trajectories are bitwise unchanged."""
    return jnp.promote_types(dtype, jnp.float32)


class AdamState(NamedTuple):
    mu: jnp.ndarray          # [n, p] first moment
    nu: jnp.ndarray          # [n, p] second moment
    count: jnp.ndarray       # scalar int32, completed steps
    learning_rate: jnp.ndarray  # scalar, decayed multiplicatively


class AdagradState(NamedTuple):
    hist: jnp.ndarray        # [n, p] decayed squared-gradient history
    count: jnp.ndarray       # scalar int32
    learning_rate: jnp.ndarray  # scalar (never decayed — reference quirk)


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam step rule (reference: adam_gradient_descent.py:15-58)."""

    learning_rate: float = 1e-3
    decay: float = 1.0
    beta_1: float = 0.9
    beta_2: float = 0.999

    def init(self, shape, dtype):
        # Moment arrays live in the particle dtype (memory-bound at
        # [n, p] each); the lr scalar lives at >= f32 — see _scalar_dtype.
        return AdamState(
            mu=jnp.zeros(shape, dtype),
            nu=jnp.zeros(shape, dtype),
            count=jnp.zeros((), jnp.int32),
            learning_rate=jnp.asarray(
                self.learning_rate, _scalar_dtype(dtype)
            ),
        )

    def update(self, state, phi):
        # All arithmetic runs at >= f32 (_scalar_dtype): bf16 cannot even
        # represent beta_2=0.999 (the nearest bf16 is exactly 1.0), which
        # made 1 - b2**t == 0 -> nu_hat = inf -> EVERY step exactly zero;
        # the lr decay similarly rounds back to its old value. For
        # f32/f64 particles sdt == dtype and this is bitwise the original
        # oracle-pinned expression tree (tests/test_optimizers.py). The
        # moments are stored back in the particle dtype — their EMA
        # re-rounds each step (bounded, non-accumulating); the step
        # itself is computed from the full-precision update.
        dtype = phi.dtype
        sdt = _scalar_dtype(dtype)
        b1 = jnp.asarray(self.beta_1, sdt)
        b2 = jnp.asarray(self.beta_2, sdt)
        phis = phi.astype(sdt)
        first = state.count == 0
        mu = jnp.where(
            first, phis, b1 * state.mu.astype(sdt) + (1.0 - b1) * phis
        )
        nu = jnp.where(
            first, phis ** 2,
            b2 * state.nu.astype(sdt) + (1.0 - b2) * phis ** 2,
        )
        t = state.count + 1
        tf_ = t.astype(sdt)
        mup = mu / (1.0 - b1 ** tf_)
        nup = nu / (1.0 - b2 ** tf_)
        step = mup / (1e-8 + jnp.sqrt(nup)) * state.learning_rate
        new_lr = state.learning_rate * jnp.asarray(self.decay, sdt)
        return step.astype(dtype), AdamState(
            mu.astype(dtype), nu.astype(dtype), t, new_lr
        )


@dataclasses.dataclass(frozen=True)
class Adagrad:
    """RMSProp-style rule (reference: adagrad_gradient_descent.py:13-44)."""

    learning_rate: float = 1e-3
    decay: float = 1.0   # accepted for API parity; never applied (reference quirk)
    alpha: float = 0.9

    def init(self, shape, dtype):
        return AdagradState(
            hist=jnp.zeros(shape, dtype),
            count=jnp.zeros((), jnp.int32),
            learning_rate=jnp.asarray(
                self.learning_rate, _scalar_dtype(dtype)
            ),
        )

    def update(self, state, phi):
        # Same >= f32 arithmetic policy as Adam.update (bitwise-identity
        # for f32/f64; see _scalar_dtype).
        dtype = phi.dtype
        sdt = _scalar_dtype(dtype)
        a = jnp.asarray(self.alpha, sdt)
        phis = phi.astype(sdt)
        first = state.count == 0
        hist = jnp.where(
            first, phis ** 2,
            a * state.hist.astype(sdt) + (1.0 - a) * phis ** 2,
        )
        step = phis / (1e-6 + jnp.sqrt(hist)) * state.learning_rate
        return step.astype(dtype), AdagradState(
            hist.astype(dtype), state.count + 1, state.learning_rate
        )


# Reference-compatible aliases (stein/optimizers/__init__.py:1-2).
AdamGradientDescent = Adam
AdagradGradientDescent = Adagrad
