"""Hierarchical Bayesian logistic regression via SVGD — port of
the reference workload (reference: examples/logistic_regression/main.py).

Same model and hyperparameters: Gamma(1, 0.01) prior on precision alpha,
N(0, alpha^-1/2) prior on weights, sigmoid-CE likelihood rescaled by
n_train/n_batch; 100 particles, Adam lr=1e-1, minibatch 50, held-out accuracy
of particle-averaged logits every 100 iterations. The reference's
covertype.mat is absent from its repo (.MISSING_LARGE_BLOBS:1), so we
generate synthetic Covertype-scale data (54 features, binary labels) by
default.

Run: python examples/logistic_regression.py [--n-iters 6000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np
import jax
import jax.numpy as jnp

from stein_jax.utils.cache import enable_compilation_cache
from stein_jax import SVGDSampler, Adam
from stein_jax.models import LogisticRegressionModel


def generate_data(seed=0, n=20000, n_feats=54):
    """Synthetic binary classification at Covertype's feature width."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_feats))
    w_true = rng.normal(size=(n_feats, 1))
    logits = X @ w_true + rng.normal(size=(n, 1)) * 0.5
    y = (logits > 0).astype(np.float64)
    return X, y


def load_covertype(path):
    """Load the reference's covertype.mat with its exact semantics
    (reference: examples/logistic_regression/main.py:11-13): the 'covtype'
    matrix's first column is the label (2 relabelled to 0), the rest are
    features. The file itself is absent from the reference repo
    (.MISSING_LARGE_BLOBS:1) — supply your own copy via --data."""
    from scipy import io
    data = io.loadmat(path)["covtype"]
    X, y = data[:, 1:], data[:, :1].astype(np.float64)
    y[y == 2] = 0.0
    return X, y


def main():
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iters", type=int, default=6000)
    ap.add_argument("--n-particles", type=int, default=100)
    ap.add_argument("--n-batch", type=int, default=50)
    ap.add_argument("--n-prog", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-data", type=int, default=20000,
                    help="dataset rows (581012 = true Covertype scale)")
    ap.add_argument("--data", type=str, default=None,
                    help="path to covertype.mat — loads the REAL Covertype "
                         "dataset with the reference's semantics "
                         "(logistic_regression/main.py:11-16) instead of "
                         "synthetic data")
    ap.add_argument("--on-device-sampling", action="store_true",
                    help="sample minibatch indices ON DEVICE inside the "
                         "scan (sampler.train_minibatched): the full "
                         "dataset stays resident in HBM and no host RNG "
                         "or index staging runs in the loop — the "
                         "full-scale mode for the real 581k-row "
                         "Covertype (--data covertype.mat)")
    ap.add_argument("--precision", type=str, default="high",
                    choices=["high", "default", "highest"],
                    help="model data-matmul precision: 'high' (default) and "
                         "'default' run TF32 products on an H100, "
                         "'highest' full f32 (models/distributions.py)")
    args = ap.parse_args()

    if args.data:
        X, y = load_covertype(args.data)
    else:
        X, y = generate_data(args.seed, n=args.n_data)
    n_total = X.shape[0]
    # Shuffled 80/20 train/test split (the reference's
    # train_test_split(test_size=0.2), main.py:14-16, seeded here for
    # reproducibility).
    rng = np.random.default_rng(args.seed + 1)
    perm = rng.permutation(n_total)
    n_test = n_total // 5
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    X_train, y_train = X[train_idx], y[train_idx]
    X_test, y_test = X[test_idx], y[test_idx]
    n_train, n_feats = X_train.shape

    model = LogisticRegressionModel(n_feats, n_train, args.n_batch,
                                    precision=args.precision)
    test_batch = {"X": jnp.asarray(X_test, jnp.float32),
                  "y": jnp.asarray(y_test, jnp.float32)}

    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=model.log_p,
        param_template=model.template(),
        gd=Adam(learning_rate=1e-1),
        key=jax.random.PRNGKey(args.seed),
    )

    def evaluate():
        # Particle-averaged logits thresholded at 0, as the reference's
        # evaluate() does (logistic_regression/main.py:52-61).
        logits_pred = sampler.function_posterior(model.logits, test_batch)
        avg_pred = logits_pred.mean(axis=0) > 0.0
        return np.mean(avg_pred == y_test.ravel())

    start = time.time()
    # One device dispatch per n_prog minibatch steps: pre-sample the index
    # matrix and scan (sampler.train_on_batches) instead of the reference's
    # step-per-session-call loop (logistic_regression/main.py:72-79).
    X_train_j = jnp.asarray(X_train, jnp.float32)
    y_train_j = jnp.asarray(y_train, jnp.float32)
    train_data = {"X": X_train_j, "y": y_train_j}
    for i in range(0, args.n_iters, args.n_prog):
        acc = evaluate()
        print(f"Iteration {i} / {args.n_iters}: {acc:4f}")
        k = min(args.n_prog, args.n_iters - i)
        if args.on_device_sampling:
            # Full dataset resident in HBM; indices drawn inside the
            # scan (see SVGDSampler.train_minibatched) — no host RNG or
            # index staging in the loop.
            sampler.train_minibatched(
                train_data, k, args.n_batch,
                jax.random.fold_in(jax.random.PRNGKey(args.seed + 2), i),
            )
        else:
            idx = np.stack([
                rng.choice(n_train, args.n_batch, replace=False)
                for _ in range(k)
            ])
            sampler.train_on_batches(
                {"X": X_train_j[idx], "y": y_train_j[idx]}
            )
    print(f"Final accuracy: {evaluate():4f}")
    print(f"Time elapsed: {time.time() - start:.2f}s")


if __name__ == "__main__":
    main()
