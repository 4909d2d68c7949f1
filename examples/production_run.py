"""Production-shaped SVGD run: compilation cache, crash-recoverable
training loop with atomic checkpoints, divergence detection, metrics
logging, and a KSD convergence report.

Kill it at any point and re-run — it resumes from the last checkpoint and
finishes with the identical trajectory (utils/recovery.py). On a
multi-chip machine, pass --mesh to shard particles.

Run: python examples/production_run.py [--mesh] [--ckpt /tmp/svgd.ckpt]
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
from stein_jax.parallel import particle_mesh
from stein_jax.utils.metrics import MetricsLogger
from stein_jax.utils.recovery import train_with_recovery


def main():
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iters", type=int, default=3000)
    ap.add_argument("--n-particles", type=int, default=128)
    ap.add_argument("--n-batch", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--ckpt", type=str, default="/tmp/svgd_production.ckpt")
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="shard particles over all local devices")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    n_data, n_feats = 20000, 54
    X = rng.normal(size=(n_data, n_feats))
    w_true = rng.normal(size=(n_feats, 1))
    y = (X @ w_true + rng.normal(size=(n_data, 1)) * 0.5 > 0).astype(float)
    n_test = n_data // 5
    X_train, y_train = X[n_test:], y[n_test:]
    X_test, y_test = X[:n_test], y[:n_test]
    n_train = X_train.shape[0]

    model = LogisticRegressionModel(n_feats, n_train, args.n_batch)
    sampler = SVGDSampler(
        n_particles=args.n_particles, log_p=model.log_p,
        param_template=model.template(), gd=Adam(learning_rate=1e-1),
        key=jax.random.PRNGKey(args.seed),
        mesh=particle_mesh() if args.mesh else None,
    )

    X_j = jnp.asarray(X_train, jnp.float32)
    y_j = jnp.asarray(y_train, jnp.float32)

    def make_batches(start_step, k):
        # Deterministic in start_step so a resumed run replays the exact
        # minibatch sequence (bit-identical recovery).
        seq = np.random.default_rng(args.seed + 2 + start_step)
        idx = np.stack([
            seq.choice(n_train, args.n_batch, replace=False)
            for _ in range(k)
        ])
        return {"X": X_j[idx], "y": y_j[idx]}

    # Append to the CSV only when this invocation actually resumes from a
    # checkpoint (a fresh run with a stale CSV at the same path must
    # truncate, not interleave two histories).
    resuming = os.path.exists(args.ckpt)
    metrics = MetricsLogger(log_every=0, csv_path=args.csv, resume=resuming)
    test_batch = {"X": jnp.asarray(X_test, jnp.float32),
                  "y": jnp.asarray(y_test, jnp.float32)}

    def on_checkpoint(step, aux):
        metrics.record(step, jax.tree_util.tree_map(lambda a: a[-1], aux))
        logits = sampler.function_posterior(model.logits, test_batch)
        acc = np.mean((logits.mean(axis=0) > 0) == y_test.ravel())
        print(f"step {step}: held-out acc {acc:.4f}, "
              f"phi_norm {metrics.history[-1]['phi_norm']:.3g}, "
              f"checkpointed -> {args.ckpt}")

    t0 = time.time()
    executed = train_with_recovery(
        sampler, args.n_iters, make_batches, args.ckpt,
        ckpt_every=args.ckpt_every, on_checkpoint=on_checkpoint,
    )
    metrics.close()
    print(f"executed {executed} steps this invocation "
          f"({time.time() - t0:.1f}s); total step count "
          f"{int(sampler.state.step)}")
    # KSD against the trained-for target: log_p's n_train/n_batch
    # likelihood scaling assumes an n_batch-sized batch, so evaluate on
    # one (a full test batch would correspond to a different posterior).
    ksd_batch = {"X": X_j[:args.n_batch], "y": y_j[:args.n_batch]}
    print(f"final KSD^2: {sampler.ksd(ksd_batch):.4g}")


if __name__ == "__main__":
    main()
