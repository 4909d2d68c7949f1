"""SVGD on a 2-D Gaussian mixture — the multimodality demo.

The reference's examples are all unimodal GLM/NN posteriors; the defining
property of SVGD over point-estimate VI (and the reason the reference's
README cites Liu & Wang) is that the repulsive term spreads particles
across SEPARATED modes in proportion to their mass. This example samples a
K-component 2-D mixture and reports per-mode mass, mean error, and KSD —
the reference-style "print diagnostics a human checks" workload
(SURVEY.md §4), with no reference analogue to port.

Run: python examples/gaussian_mixture.py [--n-particles 200]
     [--weights 0.5,0.3,0.2] [--plot mixture.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from stein_jax.utils.cache import enable_compilation_cache
from stein_jax import SVGDSampler, Adam


def make_mixture(weights, spread=4.0, sigma=0.6):
    """Equally-spaced modes on a circle of radius ``spread``."""
    k = len(weights)
    ang = 2 * np.pi * np.arange(k) / k
    mus = spread * np.stack([np.cos(ang), np.sin(ang)], axis=1)  # [k, 2]
    log_w = jnp.asarray(np.log(np.asarray(weights)))
    mus_j = jnp.asarray(mus)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)

    def log_p(params, batch):
        x = params["x"]                                   # [2]
        d2 = jnp.sum((mus_j - x) ** 2, axis=1)            # [k]
        return jax.scipy.special.logsumexp(log_w - d2 * inv2s2)

    return log_p, mus, sigma


def main():
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-particles", type=int, default=200)
    ap.add_argument("--n-iters", type=int, default=2000)
    ap.add_argument("--weights", type=str, default="0.5,0.3,0.2")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", type=str, default=None)
    args = ap.parse_args()

    weights = [float(w) for w in args.weights.split(",")]
    weights = [w / sum(weights) for w in weights]
    log_p, mus, sigma = make_mixture(weights)

    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=log_p,
        param_template={"x": jnp.zeros((2,), jnp.float32)},
        gd=Adam(learning_rate=args.lr),
        key=jax.random.PRNGKey(args.seed),
    )
    # 0.01*N(0,I) init sits between the modes; the repulsive term must
    # push particles out to ALL of them.
    sampler.run(batch=None, n_steps=args.n_iters)
    s = sampler.samples                                   # [n, 2]

    # Assign each particle to its nearest mode.
    d2 = ((s[:, None, :] - mus[None, :, :]) ** 2).sum(-1)  # [n, k]
    assign = d2.argmin(axis=1)
    print(f"KSD^2: {sampler.ksd(None):.4g}")
    max_mass_err = 0.0
    for k, (w, mu) in enumerate(zip(weights, mus)):
        mask = assign == k
        mass = mask.mean()
        mean_err = (np.abs(s[mask].mean(axis=0) - mu).max()
                    if mask.any() else float("inf"))
        max_mass_err = max(max_mass_err, abs(mass - w))
        print(f"mode {k}: true mass {w:.3f}, particle mass {mass:.3f}, "
              f"mean err {mean_err:.3f}")
    print(f"max mass error: {max_mass_err:.4f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        g = np.linspace(-7, 7, 200)
        GX, GY = np.meshgrid(g, g)
        P = sum(
            w * np.exp(-((GX - m[0]) ** 2 + (GY - m[1]) ** 2)
                       / (2 * sigma ** 2))
            for w, m in zip(weights, mus)
        )
        plt.figure(figsize=(6, 6))
        plt.contour(GX, GY, P, levels=8, alpha=0.5)
        plt.plot(s[:, 0], s[:, 1], "b.", ms=4, alpha=0.6)
        plt.savefig(args.plot, dpi=120)
        print(f"Saved figure to {args.plot}")


if __name__ == "__main__":
    main()
