"""Smoke run of the SVGD main path on an NVIDIA GPU, at full width.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the mesh phase only

Phases on one card, each checked against the repo's plain reference:

- linreg: Bayesian linear regression, n=1000 particles, p=128, Adam,
  through throughput_config; one step against the float64 NumPy oracle
  (baselines/numpy_svgd.py), then 500 scanned steps against the
  conjugate posterior mean.
- covertype: synthetic data at the shape of the reference's Covertype
  workload (464,809 x 54 training rows of Gaussian features with
  linearly separable labels, resident on the device; 100 particles,
  minibatch 50, Adam) through train_minibatched; held-out accuracy on
  the synthetic split must rise. The real Covertype data is not in the
  repository, so no accuracy on it is claimed.
- bnn: the reference Bayesian NN (1 -> 100 -> 1 ReLU, p=303) at n=1000
  through throughput_config; one step against the same step at full f32
  precision, then 300 scanned steps.
- large_n: n=10240, p=128 through throughput_config (the XLA phi path)
  and through the opt-in streaming tile (kernel_impl="pallas"); each
  phi against ops/rbf.svgd_phi at HIGHEST with the same h^2, and the
  memory of both steps.

With --devices 4 the mesh phase runs the 1-D particle mesh (all_gather
and ring, warm bisect median) and the 2x2 particles x model mesh, each at
n=4096/p=128 and at the Bayesian-NN shape, against the single-device step
on device 0.

The last line of standard output is one JSON object naming the device;
it is printed only after every phase passed. Without a GPU the script
exits non-zero and prints no result.
"""

import argparse
import json
import sys
import time

from bench import card_info, make_data

ONE_CARD_PHASES = ("linreg", "covertype", "bnn", "large_n")
FOUR_CARD_PHASES = ("mesh",)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1 (default): every single-card phase; 4: only "
                         "the four-card mesh phase")
    return ap.parse_args(argv)


def phases_for(devices):
    return FOUR_CARD_PHASES if devices == 4 else ONE_CARD_PHASES


def check_devices(devices, want):
    """Refuse anything but ``want`` or more GPUs: no fallback to the CPU."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found "
                         f"platform {platform!r}")
    if len(devices) < want:
        raise SystemExit(f"chip_smoke: needs {want} GPUs, JAX found "
                         f"{len(devices)}")


def rel_err(got, ref):
    import numpy as np
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def expect(name, value, limit):
    """Print a measured error beside its limit; raise if it is over."""
    ok = value <= limit
    print(f"  {name}: {value:.3e} (limit {limit:.0e}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} = {value} > {limit}")


def finite(name, x):
    import numpy as np
    if not np.isfinite(np.asarray(x)).all():
        raise AssertionError(f"{name} holds non-finite values")


def phase_linreg():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from baselines.numpy_svgd import NumpyAdam, NumpySVGD
    from stein_jax import Adam, SVGDSampler, throughput_config
    from stein_jax.models import LinearRegressionModel

    n, p = 1000, 128
    X, y, theta0 = make_data(n, p)
    model = LinearRegressionModel(p)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    cfg = throughput_config(n, p)
    print(f"  config {cfg}", flush=True)

    def make(**kw):
        return SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(),
            gd=Adam(learning_rate=1e-1, decay=0.995),
            theta=jnp.asarray(theta0, jnp.float32), **dict(cfg, **kw),
        )

    # One step against the oracle. The median subsample covers every row
    # here, so the bisect median is the oracle's exact median. After one
    # Adam step the first moment is the clipped phi itself.
    one = make(median_max_rows=n)
    aux = one.train_on_batch(batch)
    oracle = NumpySVGD(
        lambda w, b: (X.T @ (y - X @ w.reshape(-1, 1)) - w.reshape(-1, 1)
                      ).ravel(),
        theta0, NumpyAdam(learning_rate=1e-1, decay=0.995),
    )
    oracle.train_on_batch(None)
    expect("h2 vs oracle (rel)",
           abs(float(aux["h2"]) / oracle.last_h2 - 1.0), 1e-5)
    expect("clipped phi vs oracle (max rel)",
           rel_err(one.state.opt_state.mu, oracle.gd.mu), 2e-3)

    s = make()
    t0 = time.perf_counter()
    aux = s.run(batch, 500)
    jax.block_until_ready(s.state)
    print(f"  500 steps incl. compile: {time.perf_counter() - t0:.2f} s",
          flush=True)
    finite("linreg particles", s.samples)
    A = X.T @ X + np.eye(p)
    post_mean = np.linalg.solve(A, X.T @ y).ravel()
    post_sd = np.sqrt(np.diag(np.linalg.inv(A)))
    err = np.abs(s.samples.mean(axis=0) - post_mean)
    expect("posterior mean vs conjugate (max abs / posterior sd)",
           float((err / post_sd).max()), 1.0)


def phase_covertype():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from stein_jax import Adam, SVGDSampler, throughput_config
    from stein_jax.models import LogisticRegressionModel

    n_rows, d, n, n_batch, n_iters = 581012, 54, 100, 50, 1000
    rng = np.random.default_rng(13)
    X = rng.normal(size=(n_rows, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float32)
    n_train = n_rows * 4 // 5
    data = {"X": jnp.asarray(X[:n_train]), "y": jnp.asarray(y[:n_train])}
    test = {"X": jnp.asarray(X[n_train:]), "y": y[n_train:].ravel()}
    print(f"  training rows on device: {data['X'].shape} "
          f"({(data['X'].nbytes + data['y'].nbytes) / 1e6:.0f} MB)",
          flush=True)
    model = LogisticRegressionModel(d, n_train=n_train, n_batch=n_batch)
    cfg = throughput_config(n, d + 1)
    s = SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(5), **cfg,
    )

    def accuracy():
        logits = s.function_posterior(model.logits, test)
        return float(np.mean((logits.mean(axis=0) > 0) == (test["y"] > 0.5)))

    acc0 = accuracy()
    t0 = time.perf_counter()
    for chunk in range(4):
        aux = s.train_minibatched(data, n_iters // 4, n_batch,
                                  jax.random.PRNGKey(7 + chunk))
    jax.block_until_ready(s.state)
    print(f"  {n_iters} minibatch steps incl. compile: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    finite("covertype particles", s.samples)
    finite("covertype log_p", aux["log_p_mean"])
    acc1 = accuracy()
    print(f"  held-out accuracy on the synthetic split {acc0:.4f} -> "
          f"{acc1:.4f}", flush=True)
    if not (acc1 > acc0 + 0.2 and acc1 > 0.9):
        raise AssertionError(f"held-out accuracy {acc0} -> {acc1}")


def bnn_batch(n_obs=20, seed=11):
    """The reference regression data: y = cos(10x) 5x + noise."""
    import numpy as np
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n_obs, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    return {"X": jnp.asarray(X, jnp.float32),
            "y": jnp.asarray(y, jnp.float32)}


def phase_bnn():
    import jax
    from stein_jax import Adam, SVGDSampler, throughput_config
    from stein_jax.models import BayesianNNModel

    n, n_obs = 1000, 20
    batch = bnn_batch(n_obs)
    cfg = throughput_config(n, 303)

    def make(precision):
        model = BayesianNNModel(1, 100, n_obs, n_obs, prior_beta=10.0,
                                precision=precision)
        return SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(),
            gd=Adam(learning_rate=1e-1, decay=0.999),
            key=jax.random.PRNGKey(3), **cfg,
        ), model

    s, model = make("high")
    if s.n_params != 303:
        raise AssertionError(f"the reference NN has p=303, got {s.n_params}")
    print(f"  config {cfg}", flush=True)
    aux = s.train_on_batch(batch)
    with jax.default_matmul_precision("highest"):
        ref, _ = make("highest")
        aux_ref = ref.train_on_batch(batch)
        jax.block_until_ready(ref.state)
    # TF32 products in the model and the phi contraction against full
    # f32: ~1e-3 relative class.
    expect("clipped phi vs full f32 (max rel)",
           rel_err(s.state.opt_state.mu, ref.state.opt_state.mu), 1e-2)
    expect("h2 vs full f32 (rel)",
           abs(float(aux["h2"]) / float(aux_ref["h2"]) - 1.0), 1e-3)
    expect("log_p vs full f32 (rel)",
           abs(float(aux["log_p_mean"]) / float(aux_ref["log_p_mean"])
               - 1.0), 5e-3)

    def mse():
        pred = s.function_posterior(model.predict, batch, axis=0)
        return float(((pred - batch["y"].ravel()) ** 2).mean())

    mse0 = mse()
    t0 = time.perf_counter()
    aux = s.run(batch, 300)
    jax.block_until_ready(s.state)
    mse1 = mse()
    print(f"  300 steps incl. compile: {time.perf_counter() - t0:.2f} s; "
          f"train MSE of the mean prediction {mse0:.4f} -> {mse1:.4f}",
          flush=True)
    finite("bnn particles", s.samples)
    finite("bnn log_p", aux["log_p_mean"])
    if not mse1 < mse0:
        raise AssertionError(f"BNN train MSE did not fall: {mse0} -> {mse1}")


def phase_large_n(n=10240, p=128):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from stein_jax import Adam, SVGDSampler, throughput_config
    from stein_jax.models import LinearRegressionModel
    from stein_jax.ops import rbf
    from stein_jax.ops.median import bisect_median
    from stein_jax.ops.pallas_svgd import pallas_svgd_phi

    cfg = throughput_config(n, p)
    print(f"  config {cfg}", flush=True)
    rng = np.random.default_rng(2)
    theta = jnp.asarray(rng.normal(size=(n, p)) + 3.0, jnp.float32)
    grads = jnp.asarray(rng.normal(size=(n, p)), jnp.float32)
    med = bisect_median(theta, max_rows=cfg.get("median_max_rows", 512))
    h2 = rbf.bandwidth_sq_from_median(med, n)

    def xla_phi(t, g):
        return rbf.svgd_phi(t, g, median_fn=lambda D: med)[0]

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(xla_phi)(theta, grads)
    # The XLA path's TF32 K contraction (its Gram stays at HIGHEST), and
    # the tile's TF32 Gram (centred) and contraction.
    expect("XLA phi vs rbf.svgd_phi at HIGHEST (max rel)",
           rel_err(jax.jit(xla_phi)(theta, grads), ref), 2e-3)
    expect("tile phi vs rbf.svgd_phi at HIGHEST (max rel)",
           rel_err(pallas_svgd_phi(theta, grads, h2), ref), 2e-3)

    X, y, theta0 = make_data(n, p, seed=1)
    model = LinearRegressionModel(p)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    for name, kw in (("throughput_config", {}),
                     ("tile", {"kernel_impl": "pallas"})):
        s = SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(), gd=Adam(learning_rate=1e-2),
            theta=jnp.asarray(theta0, jnp.float32), **cfg, **kw,
        )
        t0 = time.perf_counter()
        aux = s.run(batch, 20)
        jax.block_until_ready(s.state)
        print(f"  {name}: 20 steps incl. compile: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        finite(f"large-n {name} particles", s.samples)
        finite(f"large-n {name} phi norm", aux["phi_norm"])
        mem = s._jit_run.lower(s.state, batch, 20).compile().memory_analysis()
        print(f"  {name}: compiled run(20) temp "
              f"{mem.temp_size_in_bytes / 1e6:.1f} MB, arguments "
              f"{mem.argument_size_in_bytes / 1e6:.1f} MB", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


def _padded_bnn(n_obs):
    """The Bayesian NN with one extra N(0, 1) parameter, so p=304 divides
    the 2-way model axis of the 2x2 mesh."""
    import jax.numpy as jnp
    from stein_jax.models import BayesianNNModel
    from stein_jax.models.distributions import normal_log_prob

    base = BayesianNNModel(1, 100, n_obs, n_obs, prior_beta=10.0)

    class Padded:
        def template(self, dtype=jnp.float32):
            return dict(base.template(dtype), pad=jnp.zeros((1,), dtype))

        def log_p(self, params, batch):
            rest = {k: v for k, v in params.items() if k != "pad"}
            return base.log_p(rest, batch) + jnp.sum(
                normal_log_prob(params["pad"], 0.0, 1.0))

    return Padded()


def phase_mesh(n=4096, n_nn=1000):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from stein_jax import Adam, SVGDSampler
    from stein_jax.models import LinearRegressionModel

    devs = jax.devices()[:4]
    mesh1 = Mesh(np.asarray(devs), ("particles",))
    mesh2 = Mesh(np.asarray(devs).reshape(2, 2), ("particles", "model"))
    n_obs = 20
    shapes = []
    X, y, theta_lin = make_data(n, 128, seed=4)
    shapes.append((f"n{n}_p128", LinearRegressionModel(128), theta_lin,
                   {"X": jnp.asarray(X, jnp.float32),
                    "y": jnp.asarray(y, jnp.float32)}))
    rng = np.random.default_rng(6)
    shapes.append((f"nn_n{n_nn}_p304", _padded_bnn(n_obs),
                   rng.normal(size=(n_nn, 304)) * 0.1, bnn_batch(n_obs)))
    layouts = (
        ("1d_all_gather", dict(mesh=mesh1, comm="all_gather")),
        ("1d_ring", dict(mesh=mesh1, comm="ring")),
        ("2x2_rounds", dict(mesh=mesh2, model_axis="model",
                            median_collectives="rounds")),
        ("2x2_grid", dict(mesh=mesh2, model_axis="model",
                          median_collectives="grid")),
    )
    # The grid search refines the same verified bracket as the rounds
    # search to the same width, not to the same point: its median, and
    # so phi, agree to the bandwidth class only.
    limits = {"2x2_grid": (5e-2, 5e-3)}
    for shape, model, theta0, batch in shapes:
        n_shape = theta0.shape[0]
        # Every row in the median subsample: the sharded and the
        # single-device warm searches then count the same entries.
        common = dict(
            n_particles=n_shape, log_p=model.log_p,
            param_template=model.template(),
            theta=jnp.asarray(theta0, jnp.float32), median="bisect",
            warm_median=True, median_max_rows=n_shape,
        )
        ref = SVGDSampler(gd=Adam(learning_rate=1e-2), **common)
        aux_ref = ref.run(batch, 3)
        jax.block_until_ready(ref.state)
        for name, kw in layouts:
            s = SVGDSampler(gd=Adam(learning_rate=1e-2), **common, **kw)
            t0 = time.perf_counter()
            aux = s.run(batch, 3)
            jax.block_until_ready(s.state)
            print(f"  {shape} {name}: 3 steps incl. compile "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            lim_mu, lim_h2 = limits.get(name, (1e-2, 1e-4))
            # Adam's first moment is the running mean of the clipped phi;
            # the particles themselves move by ~lr * sign(phi) in the
            # first steps, so phi is what is compared.
            expect(f"{shape} {name} first moment vs device 0 (max rel)",
                   rel_err(s.state.opt_state.mu, ref.state.opt_state.mu),
                   lim_mu)
            expect(f"{shape} {name} h2 vs device 0 (max rel)",
                   rel_err(aux["h2"], aux_ref["h2"]), lim_h2)
            shards = s.state.particles.addressable_shards
            print(f"  {shape} {name} particle shards: "
                  f"{[sh.data.shape for sh in shards]}", flush=True)
    for d in devs:
        stats = d.memory_stats() or {}
        print(f"  device {d.id} peak_bytes_in_use "
              f"{stats.get('peak_bytes_in_use')}", flush=True)


PHASES = {
    "linreg": phase_linreg,
    "covertype": phase_covertype,
    "bnn": phase_bnn,
    "large_n": phase_large_n,
    "mesh": phase_mesh,
}


def main(argv=None):
    args = parse_args(argv)
    import jax

    devices = jax.devices()
    check_devices(devices, args.devices)
    from stein_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    print(devices, flush=True)
    print(card_info(), flush=True)
    for name in phases_for(args.devices):
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        PHASES[name]()
        print(f"phase {name} passed in {time.perf_counter() - t0:.2f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    sys.exit(main())
