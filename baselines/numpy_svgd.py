"""Pure-NumPy SVGD oracle encoding the reference semantics exactly.

This module is the correctness referee and host-CPU speed baseline for the
JAX framework. It re-implements, in plain NumPy, the exact numerical
semantics of the reference implementation (JamesBrofos/Stein):

- SVGD direction ``phi = (K @ grads + dK) / n``
  (reference: stein/samplers/abstract_stein_sampler.py:105)
- RBF kernel ``K = exp(-D / h^2 / 2)`` with squared distances
  ``D = r + r^T - 2*T@T^T`` (reference: stein/kernels/abstract_kernel.py:33-35,
  stein/kernels/squared_exponential_kernel.py:22)
- Median-heuristic bandwidth ``h = sqrt(median(D) / log(n))`` where the median
  is taken over *all* n^2 entries of D including the zero diagonal and both
  symmetric copies (reference: stein/kernels/abstract_kernel.py:38-40,
  stein/utilities/compute_median.py:4-16; the top_k formula there is exactly
  ``np.median`` of the flattened matrix).
- Repulsive term in closed form, equal to the reference's
  ``-0.5 * tf.gradients(K, theta)`` (squared_exponential_kernel.py:29-35):
  double counting from K's symmetry contributes the factor 2, differentiating
  w.r.t. the first argument the sign; the closed form is
  ``dK_i = (sum_j K_ij * theta_i - (K @ theta)_i) / h^2``.
- Global norm clip ``phi *= 10 / max(10, ||phi||_F)``
  (abstract_stein_sampler.py:125).
- Adam step rule with the reference's quirks: first-iteration moments
  initialised to ``mu=phi, nu=phi**2`` (not zero) while bias correction is
  still applied, and a multiplicative learning-rate decay applied *after*
  producing the step (stein/optimizers/adam_gradient_descent.py:41-58).
- Adagrad (RMSProp-style) rule: ``hist = alpha*hist + (1-alpha)*phi**2`` with
  first-iteration ``hist = phi**2``; step ``phi / (1e-6 + sqrt(hist)) * lr``;
  note it does NOT decay the learning rate
  (stein/optimizers/adagrad_gradient_descent.py:34-44).
- Particle init ``0.01 * N(0, I)`` (abstract_stein_sampler.py:66-74).
"""

import numpy as np


class NumpyAdam:
    """Adam step rule matching adam_gradient_descent.py:41-58 exactly."""

    def __init__(self, learning_rate=1e-3, decay=1.0, beta_1=0.9, beta_2=0.999):
        self.learning_rate = learning_rate
        self.decay = decay
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.n_iters = 0
        self.mu = None
        self.nu = None

    def update(self, phi):
        if self.n_iters == 0:
            self.mu, self.nu = phi, phi ** 2
        else:
            self.mu = self.beta_1 * self.mu + (1.0 - self.beta_1) * phi
            self.nu = self.beta_2 * self.nu + (1.0 - self.beta_2) * phi ** 2
        self.n_iters += 1
        mup = self.mu / (1.0 - self.beta_1 ** self.n_iters)
        nup = self.nu / (1.0 - self.beta_2 ** self.n_iters)
        grad = mup / (1e-8 + np.sqrt(nup)) * self.learning_rate
        self.learning_rate *= self.decay
        return grad


class NumpyAdagrad:
    """RMSProp-style rule matching adagrad_gradient_descent.py:34-44 exactly.

    Note: unlike Adam, the reference's Adagrad never applies the learning-rate
    decay inside ``update`` — we reproduce that quirk.
    """

    def __init__(self, learning_rate=1e-3, decay=1.0, alpha=0.9):
        self.learning_rate = learning_rate
        self.decay = decay
        self.alpha = alpha
        self.n_iters = 0
        self.hist = None

    def update(self, phi):
        if self.n_iters == 0:
            self.hist = phi ** 2
        else:
            self.hist = self.alpha * self.hist + (1.0 - self.alpha) * phi ** 2
        self.n_iters += 1
        return phi / (1e-6 + np.sqrt(self.hist)) * self.learning_rate


def pairwise_sq_dists(theta):
    """D = r + r^T - 2*T@T^T  (abstract_kernel.py:33-35).

    Kept in this exact algebraic form (not ||a-b||^2 expanded per pair) so
    floating-point results track the reference's order of operations.
    """
    r = np.sum(theta * theta, axis=1, keepdims=True)
    return r + r.T - 2.0 * theta @ theta.T


def median_bandwidth_sq(D, n_particles):
    """h^2 = median(D) / log(n), median over all n^2 entries incl. diagonal.

    compute_median.py:4-16's top_k formula equals np.median of the flattened
    matrix (mean of the two middle order statistics for even counts).
    """
    med = np.median(D.ravel())
    return med / np.log(n_particles)


def rbf_kernel_and_repulse(theta):
    """Return (K, dK, h2): RBF kernel, SVGD repulsive term, bandwidth^2.

    dK equals the reference's ``-0.5 * np.vstack(tf.gradients(K, theta))``
    (squared_exponential_kernel.py:25-35), computed in closed form:
    dK_i = (sum_j K_ij * theta_i - (K @ theta)_i) / h^2.
    """
    n = theta.shape[0]
    D = pairwise_sq_dists(theta)
    h2 = median_bandwidth_sq(D, n)
    K = np.exp(-D / h2 / 2.0)
    ksum = K.sum(axis=1, keepdims=True)
    dK = (ksum * theta - K @ theta) / h2
    return K, dK, h2


def compute_phi(theta, grads):
    """phi = (K @ grads + dK) / n   (abstract_stein_sampler.py:105)."""
    n = theta.shape[0]
    K, dK, h2 = rbf_kernel_and_repulse(theta)
    return (K @ grads + dK) / n, h2


def clip_phi(phi):
    """phi *= 10 / max(10, ||phi||_F)  (abstract_stein_sampler.py:125)."""
    return phi * (10.0 / max(10.0, np.linalg.norm(phi)))


class NumpySVGD:
    """Sequential SVGD driver over flat particles, matching the reference's
    train_on_batch semantics (stein/samplers/stein_sampler.py:50-71 +
    abstract_stein_sampler.py:107-127) with a user-supplied gradient oracle.

    Parameters
    ----------
    grad_log_p : callable (theta_row [p], batch) -> grad [p]
        Per-particle gradient of the log posterior.
    theta : [n_particles, n_params] initial particles.
    gd : NumpyAdam or NumpyAdagrad.
    """

    def __init__(self, grad_log_p, theta, gd):
        self.grad_log_p = grad_log_p
        self.theta = np.array(theta, dtype=np.float64)
        self.n_particles = self.theta.shape[0]
        self.gd = gd
        self.last_h2 = None

    def train_on_batch(self, batch):
        grads = np.stack(
            [self.grad_log_p(self.theta[i], batch) for i in range(self.n_particles)]
        )
        phi, self.last_h2 = compute_phi(self.theta, grads)
        phi = clip_phi(phi)
        self.theta = self.theta + self.gd.update(phi)

    @property
    def samples(self):
        return self.theta


def init_particles(rng, n_particles, n_params):
    """0.01 * N(0, I) particle init (abstract_stein_sampler.py:66-74)."""
    return rng.normal(size=(n_particles, n_params)) * 0.01
