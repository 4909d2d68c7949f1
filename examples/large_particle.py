"""Large-particle SVGD (BASELINE.json config #4): n=10k particles on one
device, on-device median heuristic; the XLA phi path by default, the
streaming tile with --kernel-impl pallas.

Bayesian linear regression is used as the target so posterior moments can
be checked against the conjugate closed form at this particle count:
posterior = N((X'X+I)^-1 X'y, (X'X+I)^-1).

Run: python examples/large_particle.py [--n-particles 10240]
     [--kernel-impl xla|pallas] [--median bisect|subsample|binned]
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
from stein_jax.models import LinearRegressionModel


def main():
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-particles", type=int, default=10240)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--n-obs", type=int, default=1000)
    ap.add_argument("--n-iters", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--kernel-impl", type=str, default="xla",
                    choices=["xla", "pallas"],
                    help="'xla' (default, the Gram at full f32) or "
                         "'pallas': the streaming tile, one device only, "
                         "with its Gram in TF32")
    ap.add_argument("--median", type=str, default="bisect",
                    choices=["bisect", "subsample", "binned", "exact"])
    ap.add_argument("--median-passes", type=int, default=16)
    ap.add_argument("--warm", action="store_true",
                    help="warm-started median across scanned steps")
    ap.add_argument("--median-rows", type=int, default=None,
                    help="median row subsample (default: 128 at "
                         "n>=4096, as throughput_config picks, else 512)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the particle axis over all local devices "
                         "(kernel tiles, median counts, and the clip "
                         "norm run as collectives; use --median bisect "
                         "or binned — the sharded step has no "
                         "'subsample' mode and guards large-n 'exact')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", type=str, default="high",
                    choices=["high", "default", "highest"],
                    help="model data-matmul precision: 'high' (default) and "
                         "'default' run TF32 products on an H100, "
                         "'highest' full f32 (models/distributions.py)")
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    X = rng.normal(size=(args.n_obs, args.n_feats))
    w_true = rng.normal(size=(args.n_feats, 1))
    y = X @ w_true + rng.normal(size=(args.n_obs, 1)) * 0.5
    model = LinearRegressionModel(args.n_feats,
                                  precision=args.precision)
    batch = {"X": jnp.asarray(X, jnp.float32), "y": jnp.asarray(y, jnp.float32)}

    mesh_kwargs = {}
    if args.mesh:
        from stein_jax.parallel import particle_mesh
        mesh_kwargs["mesh"] = particle_mesh()
    kernel_impl = args.kernel_impl
    median_rows = args.median_rows
    if median_rows is None:
        median_rows = 128 if args.n_particles >= 4096 else 512

    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=model.log_p,
        param_template=model.template(),
        gd=Adam(learning_rate=1e-2),
        key=jax.random.PRNGKey(args.seed),
        kernel_impl=kernel_impl,
        median=args.median,
        median_passes=args.median_passes,
        median_max_rows=median_rows,
        warm_median=args.warm,
        **mesh_kwargs,
    )

    # Warmup compiles the scan at the exact chunk length used below (a
    # different length would recompile inside the timed loop).
    sampler.run(batch, args.chunk)
    jax.block_until_ready(sampler.state)

    t0 = time.time()
    done = args.chunk
    while done + args.chunk <= args.n_iters:
        # Full chunks only: a shorter tail chunk would be a new static
        # scan length and recompile inside the timed loop.
        aux = sampler.run(batch, args.chunk)
        done += args.chunk
    jax.block_until_ready(sampler.state)
    dt = time.time() - t0
    steps = done - args.chunk
    print(f"{steps} steps of n={args.n_particles} particles in {dt:.2f}s "
          f"-> {steps / dt:.1f} steps/s, "
          f"{args.n_particles * steps / dt / 1e6:.1f}M particle-updates/s "
          f"[{kernel_impl}/{args.median}"
          f"{f'/mesh{jax.device_count()}' if args.mesh else ''}]")

    # Conjugate posterior check.
    A = X.T @ X + np.eye(args.n_feats)
    cov = np.linalg.inv(A)
    mean = (cov @ X.T @ y).ravel()
    s = sampler.samples
    mean_err = np.abs(s.mean(axis=0) - mean).max()
    mc = np.sqrt(np.diag(cov) / args.n_particles).max()
    var_ratio = (s.var(axis=0) / np.diag(cov))
    print(f"posterior mean max-abs-err {mean_err:.3e} "
          f"(MC err scale {mc:.3e}); var ratio "
          f"[{var_ratio.min():.3f}, {var_ratio.max():.3f}]")


if __name__ == "__main__":
    main()
