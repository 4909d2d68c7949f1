"""Example acceptance tests (tiny configs, CPU).

The examples are the de-facto acceptance tests, as they were for the
reference (SURVEY.md §4): each test asserts on the actual numbers the
script prints (coefficient error, held-out accuracy, MSE trajectory) —
not just that the script ran.
"""

import re
import runpy
import sys

import numpy as np
import pytest


def _run(script, args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script] + args)
    runpy.run_path(script, run_name="__main__")
    return capsys.readouterr().out


def _floats(line):
    return [float(t) for t in
            re.findall(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?", line)]


def _line(out, prefix):
    hits = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert hits, f"no line starting with {prefix!r} in:\n{out}"
    return hits[-1]


def test_linear_regression_converges(capsys, monkeypatch):
    """Posterior-mean coefficients reach the conjugate closed form (the
    reference's printed-coefficient check, linear_regression/main.py:51-53)."""
    out = _run("examples/linear_regression.py", ["--n-iters", "400"],
               capsys, monkeypatch)
    est = _floats(_line(out, "Est. coefficients:"))
    conj = _floats(_line(out, "Conjugate posterior mean:"))
    assert len(est) == len(conj) >= 1
    np.testing.assert_allclose(est, conj, atol=5e-2)


def test_linear_regression_plot(capsys, monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    plot = str(tmp_path / "linreg.png")
    out = _run("examples/linear_regression.py",
               ["--n-iters", "60", "--plot", plot], capsys, monkeypatch)
    assert f"Saved figure to {plot}" in out
    import os
    assert os.path.getsize(plot) > 0


def test_logistic_regression_accuracy_climbs(capsys, monkeypatch):
    """Held-out accuracy of particle-averaged logits rises well above
    chance (the reference's evaluate(), logistic_regression/main.py:52-61)."""
    out = _run(
        "examples/logistic_regression.py",
        ["--n-iters", "40", "--n-particles", "8", "--n-prog", "20",
         "--n-data", "500"], capsys, monkeypatch)
    first = _floats(_line(out, "Iteration 0 /"))[-1]
    final = _floats(_line(out, "Final accuracy:"))[0]
    assert final >= 0.70, f"final accuracy {final} (started {first})"
    assert final > first


def test_regression_neural_network_mse_falls(capsys, monkeypatch):
    out = _run(
        "examples/regression_neural_network.py",
        ["--n-iters", "200", "--n-particles", "4", "--n-hidden", "8",
         "--n-prog", "100"], capsys, monkeypatch)
    first = _floats(_line(out, "Iteration: 0."))[-1]
    final = _floats(_line(out, "Final MSE:"))[0]
    assert np.isfinite(final)
    assert final < first - 0.05, f"MSE {first} -> {final}: did not learn"
    assert final < 4.7


def test_regression_neural_network_tuned_flag(capsys, monkeypatch):
    """--tuned splats throughput_config over the sampler (the warm
    bisect median at this tiny shape) and must learn the same."""
    out = _run(
        "examples/regression_neural_network.py",
        ["--n-iters", "200", "--n-particles", "4", "--n-hidden", "8",
         "--n-prog", "100", "--tuned"], capsys, monkeypatch)
    first = _floats(_line(out, "Iteration: 0."))[-1]
    final = _floats(_line(out, "Final MSE:"))[0]
    assert np.isfinite(final)
    assert final < first - 0.05, f"MSE {first} -> {final}: did not learn"


def test_production_run_recovers_and_reports(capsys, monkeypatch, tmp_path):
    out = _run(
        "examples/production_run.py",
        ["--n-iters", "40", "--n-particles", "8", "--n-batch", "16",
         "--ckpt-every", "20", "--ckpt", str(tmp_path / "prod.ckpt")],
        capsys, monkeypatch)
    accs = [_floats(ln.split("held-out acc")[1])[0]
            for ln in out.splitlines() if "held-out acc" in ln]
    assert accs and all(0.0 <= a <= 1.0 for a in accs)
    ksd = _floats(_line(out, "final KSD^2:"))[-1]   # [-1]: "KSD^2" parses a 2
    assert np.isfinite(ksd) and ksd > 0
    assert "executed 40 steps" in out


def test_large_particle_posterior_and_throughput(capsys, monkeypatch):
    out = _run(
        "examples/large_particle.py",
        ["--n-particles", "64", "--n-feats", "4", "--n-obs", "50",
         "--n-iters", "301", "--chunk", "50", "--kernel-impl", "xla"],
        capsys, monkeypatch)
    rate = _floats(_line(out, "250 steps").split("->")[1])[0]
    assert rate > 0
    err_line = _line(out, "posterior mean max-abs-err")
    mean_err = _floats(err_line)[0]
    # 64 particles / 301 iters: loose but meaningful band (measured 0.07
    # with MC error scale 0.02).
    assert mean_err < 0.2, err_line


def test_large_particle_mesh_flag(capsys, monkeypatch):
    """--mesh shards the particle axis over the (fake CPU) devices; the
    posterior check must still pass and the banner must name the mesh."""
    out = _run(
        "examples/large_particle.py",
        ["--n-particles", "64", "--n-feats", "4", "--n-obs", "50",
         "--n-iters", "301", "--chunk", "50", "--kernel-impl", "xla",
         "--mesh"],
        capsys, monkeypatch)
    assert "/mesh" in _line(out, "250 steps")
    mean_err = _floats(_line(out, "posterior mean max-abs-err"))[0]
    assert mean_err < 0.2


def test_gaussian_mixture_captures_all_modes(capsys, monkeypatch):
    """The multimodality demo: particles must populate ALL modes with
    roughly the right mass (SVGD's defining property; a point-estimate
    collapse would put ~1.0 mass on one mode)."""
    out = _run(
        "examples/gaussian_mixture.py",
        ["--n-particles", "120", "--n-iters", "1500"], capsys, monkeypatch)
    masses = []
    for ln in out.splitlines():
        if ln.startswith("mode "):
            nums = _floats(ln)
            true_w, mass, mean_err = nums[1], nums[2], nums[3]
            masses.append((true_w, mass))
            # SVGD's finite-bandwidth mass bias is ~0.1 here; 0.15 still
            # cleanly excludes a collapsed (0 or 1) mode.
            assert abs(mass - true_w) < 0.15, ln
            assert mean_err < 0.15, ln
    assert len(masses) == 3
    ksd = _floats(_line(out, "KSD^2:"))[-1]   # [-1]: "KSD^2" parses a 2
    assert 0 < ksd < 0.1


def test_load_csv_data_reads_reference_layout(tmp_path):
    """load_csv_data reads the reference's shipped CSV layout
    (examples/linear_regression/data/generator.py:12-14: np.savetxt,
    comma-delimited, one column)."""
    sys.path.insert(0, "examples")
    try:
        from linear_regression import load_csv_data
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(3)
    n, k = 40, 1
    X = rng.normal(size=(n, k))
    w = rng.normal(size=(k, 1)) * 5
    y = rng.normal(X @ w, 0.3)
    np.savetxt(tmp_path / "data_X.csv", X, delimiter=",")
    np.savetxt(tmp_path / "data_w.csv", w, delimiter=",")
    np.savetxt(tmp_path / "data_y.csv", y, delimiter=",")
    lx, lw, ly = load_csv_data(str(tmp_path))
    np.testing.assert_allclose(lx, X)
    np.testing.assert_allclose(lw, w)
    np.testing.assert_allclose(ly, y)
    assert lx.shape == (n, k) and lw.shape == (k, 1) and ly.shape == (n, 1)


def test_load_covertype_semantics(tmp_path):
    """load_covertype mirrors the reference's covertype.mat handling
    (logistic_regression/main.py:11-13): column 0 is the label with class
    2 relabelled to 0, the rest are features."""
    scipy_io = pytest.importorskip("scipy.io")
    sys.path.insert(0, "examples")
    try:
        from logistic_regression import load_covertype
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(4)
    n, k = 30, 5
    feats = rng.normal(size=(n, k))
    labels = rng.choice([1.0, 2.0], size=(n, 1))
    mat = np.concatenate([labels, feats], axis=1)
    path = str(tmp_path / "covertype.mat")
    scipy_io.savemat(path, {"covtype": mat})
    X, y = load_covertype(path)
    np.testing.assert_allclose(X, feats)
    expected = np.where(labels == 2.0, 0.0, 1.0)
    np.testing.assert_allclose(y, expected)
    assert set(np.unique(y)) <= {0.0, 1.0}


def test_logistic_regression_with_mat_file(capsys, monkeypatch, tmp_path):
    """End-to-end: the logistic example runs on a user-supplied .mat file
    through the --data branch and learns."""
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(5)
    n, k = 400, 8
    feats = rng.normal(size=(n, k))
    w = rng.normal(size=(k, 1))
    labels = np.where(feats @ w + rng.normal(size=(n, 1)) * 0.3 > 0,
                      1.0, 2.0)   # Covertype encoding: classes {1, 2}
    mat = np.concatenate([labels, feats], axis=1)
    path = str(tmp_path / "covertype.mat")
    scipy_io.savemat(path, {"covtype": mat})
    out = _run(
        "examples/logistic_regression.py",
        ["--n-iters", "40", "--n-particles", "8", "--n-prog", "20",
         "--data", path], capsys, monkeypatch)
    final = _floats(_line(out, "Final accuracy:"))[0]
    assert final >= 0.70, out


def test_linear_regression_sufficient_stats_converges(capsys, monkeypatch):
    """--sufficient-stats (precomputed X^T X / X^T y, exact algebra)
    converges to the same coefficients as the full-X run."""
    out = _run("examples/linear_regression.py",
               ["--n-iters", "400", "--sufficient-stats"],
               capsys, monkeypatch)
    est = _floats(_line(out, "Est. coefficients"))
    post = _floats(_line(out, "Conjugate posterior mean"))
    np.testing.assert_allclose(est, post, atol=0.15)
