"""Benchmark: SVGD step time on one GPU, scanned inside run(batch, K).

    python bench.py                  # every config
    python bench.py --only nn,n10240 # a subset, by name

Each config builds its sampler through the public API, compiles one
scan of K steps (reported as set-up time), then times ``reps`` more
scans of the same K with ``block_until_ready`` and reports the median
time per step. A config that fails makes the run exit non-zero; the JSON
line is printed either way with what was measured.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "card": "<name>, <limit>",
   "extra": {...}, "failed": [...]}

value / vs_baseline cover the primary config (n=1000, p=128 Bayesian
linear regression through throughput_config): particle updates per
second, and the speed-up over the float64 NumPy oracle of the
reference's per-step semantics on the same problem. The ``tile_*``
configs time the streaming tile against the XLA phi path with the same
warm median, at the shapes that decide where throughput_config selects
the tile.

    python bench.py --tile-sweep     # the tile's blocks and Gram precision

times whole steps of the tile at each block shape swept and with its Gram
in TF32 (the deployed kernel), in split TF32 (3 products) and at full
f32, beside the XLA phi path, and prints each variant's phi error
against a float64 phi: the source of tile_blocks and of the tile's
precision.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

N_PARAMS = 128
N_OBS = 1000


def make_data(n_particles, n_params=N_PARAMS, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_OBS, n_params))
    w = rng.normal(size=(n_params, 1))
    y = X @ w + rng.normal(size=(N_OBS, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_params)) * 0.01
    return X, y, theta0


def bench_numpy(X, y, theta0, steps=5):
    """Seconds per step of the float64 NumPy oracle (best of 3 windows:
    host BLAS threading makes single readings drift)."""
    from baselines.numpy_svgd import NumpyAdam, NumpySVGD

    def grad_log_p(theta_row, batch):
        w = theta_row.reshape(-1, 1)
        return (X.T @ (y - X @ w) - w).ravel()

    oracle = NumpySVGD(grad_log_p, theta0, NumpyAdam(learning_rate=1e-1))
    oracle.train_on_batch(None)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            oracle.train_on_batch(None)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def time_run(sampler, batch, K, reps=5):
    """(median seconds per step, seconds to compile and run the first
    scan) of ``sampler.run(batch, K)``."""
    import jax
    t0 = time.perf_counter()
    sampler.run(batch, K)
    jax.block_until_ready(sampler.state)
    setup = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        aux = sampler.run(batch, K)
        jax.block_until_ready(sampler.state)
        ts.append((time.perf_counter() - t0) / K)
    if not np.isfinite(np.asarray(aux["phi_norm"])).all():
        raise FloatingPointError("non-finite phi norm")
    return float(np.median(ts)), setup


def linreg_sampler(n, p=N_PARAMS, gd=None, seed=0, **cfg):
    import jax.numpy as jnp
    from stein_jax import Adam, SVGDSampler
    from stein_jax.models import LinearRegressionModel

    X, y, theta0 = make_data(n, p, seed=seed)
    model = LinearRegressionModel(p)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    sampler = SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=gd or Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0, jnp.float32), **cfg,
    )
    return sampler, batch


def nn_sampler(n, **cfg):
    """The reference Bayesian NN (1 -> 100 -> 1 ReLU, p=303, minibatch
    20)."""
    import jax
    import jax.numpy as jnp
    from stein_jax import Adam, SVGDSampler
    from stein_jax.models import BayesianNNModel

    rng = np.random.default_rng(11)
    n_obs = 20
    X = rng.uniform(size=(n_obs, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    model = BayesianNNModel(1, 100, n_obs, n_obs, prior_beta=10.0)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    sampler = SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=Adam(learning_rate=1e-1, decay=0.999),
        key=jax.random.PRNGKey(3), **cfg,
    )
    return sampler, batch


def logreg_sampler(n, **cfg):
    """Hierarchical logistic regression on synthetic data at Covertype's
    shape (54 features, minibatch 50)."""
    import jax.numpy as jnp
    from stein_jax import Adam, SVGDSampler
    from stein_jax.models import LogisticRegressionModel

    rng = np.random.default_rng(7)
    d, n_obs = 54, 50
    X = rng.normal(size=(n_obs, d))
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float64)
    model = LogisticRegressionModel(d, n_train=581012, n_batch=n_obs)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    theta0 = jnp.asarray(rng.normal(size=(n, d + 1)) * 0.1, jnp.float32)
    sampler = SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=Adam(learning_rate=1e-1), theta=theta0, **cfg,
    )
    return sampler, batch


def covertype_e2e(reps=3):
    """The reference Covertype run's shape end to end, on synthetic data
    (Gaussian features, linearly separable labels): 100 particles,
    minibatch 50, 6000 Adam iterations over a 464,809 x 54 training split
    resident on the device, minibatch indices drawn inside the scan.
    Returns (seconds per step, set-up seconds)."""
    import jax
    import jax.numpy as jnp
    from stein_jax import Adam, SVGDSampler, throughput_config
    from stein_jax.models import LogisticRegressionModel

    rng = np.random.default_rng(13)
    n_rows, d, n, n_batch, n_iters = 581012, 54, 100, 50, 6000
    n_train = n_rows * 4 // 5
    X = rng.normal(size=(n_train, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float32)
    data = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    model = LogisticRegressionModel(d, n_train=n_train, n_batch=n_batch)
    sampler = SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(5),
        **throughput_config(n, d + 1),
    )
    key = jax.random.PRNGKey(7)
    t0 = time.perf_counter()
    sampler.train_minibatched(data, n_iters, n_batch, key)
    jax.block_until_ready(sampler.state)
    setup = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sampler.train_minibatched(data, n_iters, n_batch, key)
        jax.block_until_ready(sampler.state)
        ts.append((time.perf_counter() - t0) / n_iters)
    return float(np.median(ts)), setup


def one_device_mesh(two_d=False):
    import jax
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:1])
    if two_d:
        return Mesh(devs.reshape(1, 1), ("particles", "model"))
    return Mesh(devs, ("particles",))


def configs():
    """name -> callable returning (seconds per step, set-up seconds,
    particles per step)."""
    from stein_jax import Adagrad, throughput_config as tc

    def lin(n, K, p=N_PARAMS, seed=0, gd=None, **cfg):
        return (*time_run(*linreg_sampler(n, p, gd=gd, seed=seed, **cfg),
                          K=K), n)

    c = {
        "primary": lambda: lin(1000, 1000, **tc(1000, N_PARAMS)),
        "adagrad50": lambda: lin(50, 2000, seed=3,
                                 gd=Adagrad(learning_rate=1e-1),
                                 **tc(50, N_PARAMS)),
        "logreg": lambda: (*time_run(*logreg_sampler(1000, **tc(1000, 55)),
                                     K=1000), 1000),
        "covertype_e2e": lambda: (*covertype_e2e(), 100),
        "nn": lambda: (*time_run(*nn_sampler(1000, **tc(1000, 303)),
                                 K=1000), 1000),
        "n10240": lambda: lin(10240, 100, seed=1, **tc(10240, N_PARAMS)),
        "mesh1": lambda: lin(1000, 1000, **tc(
            1000, N_PARAMS, mesh=one_device_mesh())),
        "mesh1_ring": lambda: lin(1000, 1000, comm="ring", **tc(
            1000, N_PARAMS, mesh=one_device_mesh())),
        "mesh2d": lambda: lin(1000, 1000, **tc(
            1000, N_PARAMS, mesh=one_device_mesh(True), model_axis="model")),
    }
    # The tile against the XLA phi path, each with the warm median that
    # throughput_config picks at that shape.
    for n, p, K in ((10240, 128, 100), (4096, 128, 300), (1000, 303, 1000)):
        for impl in ("xla", "pallas"):
            cfg = dict(tc(n, p), kernel_impl=impl)
            if p == N_PARAMS:
                fn = (lambda n=n, K=K, cfg=cfg: lin(n, K, seed=1, **cfg))
            else:
                fn = (lambda n=n, K=K, cfg=cfg: (
                    *time_run(*nn_sampler(n, **cfg), K=K), n))
            c[f"tile_{n}_{p}_{impl}"] = fn
    return c


def _gram_tf32(rows, cols):
    from jax.experimental import pallas as pl
    import jax
    return pl.dot(rows, cols, trans_b=True, precision=jax.lax.Precision.HIGH)


def _gram_f32(rows, cols):
    from jax.experimental import pallas as pl
    import jax
    return pl.dot(rows, cols, trans_b=True,
                  precision=jax.lax.Precision.HIGHEST)


def _split_tf32(x):
    """x = hi + lo with hi exactly representable in TF32 (10-bit
    mantissa)."""
    import jax
    import jax.numpy as jnp
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFE000),
                                      jnp.float32)
    return hi, x - hi


def _gram_tf32x3(rows, cols):
    rh, rl = _split_tf32(rows)
    ch, cl = _split_tf32(cols)
    return (_gram_tf32(rh, cl) + _gram_tf32(rl, ch)) + _gram_tf32(rh, ch)


# Gram variants of the tile: the deployed TF32 one, and two that keep
# more of D's precision (Triton's IEEE f32 dot runs on the CUDA cores).
GRAMS = {"tf32": None, "tf32x3": _gram_tf32x3, "f32": _gram_f32}
SWEEP_SHAPES = ((10240, 128, 100), (4096, 128, 300), (1000, 303, 1000))
SWEEP_BLOCKS = {
    128: ((16, 64, 4, 2), (32, 32, 4, 2), (32, 64, 4, 2), (64, 32, 4, 2),
          (64, 64, 4, 2), (32, 64, 8, 2), (64, 64, 8, 3)),
    512: ((16, 16, 4, 2), (16, 32, 4, 2), (32, 16, 4, 2)),
}


def tile_variant(gram, blocks):
    """Context in which the tile compiles with another Gram and blocks."""
    import contextlib
    from unittest import mock
    import jax
    from stein_jax.ops import pallas_svgd

    jax.clear_caches()
    stack = contextlib.ExitStack()
    if GRAMS[gram] is not None:
        stack.enter_context(mock.patch.object(pallas_svgd, "_gram",
                                              GRAMS[gram]))
    if blocks is not None:
        stack.enter_context(mock.patch.object(pallas_svgd, "tile_blocks",
                                              lambda p_pad: blocks))
    return stack


def tile_sweep_configs():
    """name -> callable, as configs(): the XLA path and every (Gram,
    blocks) variant of the tile at each decision shape."""
    from stein_jax import throughput_config as tc
    from stein_jax.ops.pallas_svgd import _next_pow2

    def timed(n, p, K, **cfg):
        if p == N_PARAMS:
            return (*time_run(*linreg_sampler(n, p, seed=1, **cfg), K=K,
                              reps=3), n)
        return (*time_run(*nn_sampler(n, **cfg), K=K, reps=3), n)

    def variant(n, p, K, gram, blocks):
        with tile_variant(gram, blocks):
            return timed(n, p, K, **dict(tc(n, p), kernel_impl="pallas"))

    c = {}
    for n, p, K in SWEEP_SHAPES:
        c[f"sweep_{n}_{p}_xla"] = (
            lambda n=n, p=p, K=K: timed(n, p, K, **dict(tc(n, p),
                                                        kernel_impl="xla")))
        for gram in GRAMS:
            for b in SWEEP_BLOCKS[_next_pow2(p)]:
                c[f"sweep_{n}_{p}_{gram}_{b[0]}x{b[1]}w{b[2]}s{b[3]}"] = (
                    lambda n=n, p=p, K=K, gram=gram, b=b:
                    variant(n, p, K, gram, b))
    return c


def tile_precision_errors(n=4096, p=128):
    """Max relative phi error against float64, same h^2, for the XLA path
    and each Gram variant of the tile, on a cloud off the origin and on a
    tight cluster (spread 1e-3 at norm ~8, where D cancels)."""
    import jax
    import jax.numpy as jnp
    from stein_jax.ops import rbf
    from stein_jax.ops.pallas_svgd import pallas_svgd_phi

    rng = np.random.default_rng(5)
    clouds = {
        "shift3": rng.normal(size=(n, p)) + 3.0,
        "cluster": rng.normal(size=(1, p)) * 8 / np.sqrt(p)
        + rng.normal(size=(n, p)) * 1e-3,
    }
    grads = rng.normal(size=(n, p))
    out = {}
    for cloud, theta in clouds.items():
        t32 = np.asarray(jnp.asarray(theta, jnp.float32), np.float64)
        c = t32 - t32.mean(0)
        r = (c * c).sum(1)
        D = r[:, None] + r[None, :] - 2 * c @ c.T
        h2 = float(np.median(D) / np.log(n))
        K = np.exp(-D / h2 / 2)
        ref = (K @ grads + (K.sum(1, keepdims=True) * c - K @ c) / h2) / n

        def err(got):
            return float(np.abs(np.asarray(got, np.float64) - ref).max()
                         / np.abs(ref).max())

        tj = jnp.asarray(t32, jnp.float32)
        gj = jnp.asarray(grads, jnp.float32)
        xla, _ = jax.jit(lambda t, g: rbf.svgd_phi(
            t, g, median_fn=lambda D: jnp.float32(h2 * np.log(n))))(tj, gj)
        out[f"{cloud}_xla"] = err(xla)
        for gram in GRAMS:
            with tile_variant(gram, None):
                out[f"{cloud}_tile_{gram}"] = err(
                    pallas_svgd_phi(tj, gj, jnp.float32(h2)))
    return out


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated config names")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="time the tile's Gram and block variants "
                         "against XLA instead of the configs")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found platform "
                         f"{devices[0].platform!r}")
    from stein_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    all_configs = tile_sweep_configs() if args.tile_sweep else configs()
    names = list(all_configs)
    if args.only:
        names = args.only.split(",")
        unknown = set(names) - set(all_configs)
        if unknown:
            raise SystemExit(f"bench: unknown configs {sorted(unknown)}")

    extra, failed = {}, []
    for name in names:
        try:
            t, setup, n = all_configs[name]()
        except Exception:  # noqa: BLE001 - reported, then the run fails
            traceback.print_exc()
            failed.append(name)
            continue
        extra[f"{name}_step_us"] = t * 1e6
        extra[f"{name}_updates_per_s"] = n / t
        extra[f"{name}_setup_s"] = setup
        print(f"bench: {name} {t * 1e6:.2f} us/step (set-up {setup:.1f} s)",
              file=sys.stderr, flush=True)

    if args.tile_sweep:
        errs = tile_precision_errors()
        for k, v in errs.items():
            extra[f"phi_err_{k}"] = v
            print(f"bench: phi error {k} {v:.3e}", file=sys.stderr,
                  flush=True)
    value = vs = None
    if "primary_step_us" in extra:
        t = extra["primary_step_us"] * 1e-6
        value = 1000 / t
        X, y, theta0 = make_data(1000)
        vs = bench_numpy(X, y, theta0) / t
    print(json.dumps({
        "metric": f"particle-updates/s (n=1000, p={N_PARAMS})",
        "value": value,
        "unit": "particle-updates/s",
        "vs_baseline": vs,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
        "card": card_info(),
        "extra": extra,
        "failed": failed,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
