"""The parts of chip_smoke.py and bench.py that run without a card:
argument parsing, the choice of phases, and refusing anything but a
GPU (no fallback to the CPU, no result printed)."""

import types

import pytest

import bench
import chip_smoke


@pytest.mark.parametrize("argv,devices,phases", [
    ([], 1, chip_smoke.ONE_CARD_PHASES),
    (["--devices", "1"], 1, chip_smoke.ONE_CARD_PHASES),
    (["--devices", "4"], 4, ("mesh",)),
])
def test_args_choose_phases(argv, devices, phases):
    args = chip_smoke.parse_args(argv)
    assert args.devices == devices
    assert chip_smoke.phases_for(args.devices) == phases
    assert set(phases) <= set(chip_smoke.PHASES)


def test_one_card_runs_every_single_card_phase():
    assert chip_smoke.ONE_CARD_PHASES == ("linreg", "covertype", "bnn",
                                          "large_n")
    assert "mesh" not in chip_smoke.ONE_CARD_PHASES


@pytest.mark.parametrize("argv", [["--devices", "2"], ["--devices", "x"],
                                  ["--bogus"]])
def test_bad_args_exit_non_zero(argv):
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_args(argv)
    assert e.value.code != 0


def _dev(platform):
    return types.SimpleNamespace(platform=platform, device_kind="x")


@pytest.mark.parametrize("devices,want", [
    ([_dev("cpu")], 1),
    ([_dev("cpu")] * 8, 4),
    ([], 1),
    ([_dev("gpu")], 4),
])
def test_refuses_what_is_not_enough_gpus(devices, want):
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_devices(devices, want)
    assert e.value.code not in (0, None)


def test_accepts_gpus():
    chip_smoke.check_devices([_dev("gpu")] * 4, 4)
    chip_smoke.check_devices([_dev("gpu")], 1)


@pytest.mark.parametrize("argv", [[], ["--devices", "4"]])
def test_main_on_cpu_exits_without_a_result(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_bench_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_bench_config_names():
    names = set(bench.configs())
    assert {"primary", "nn", "n10240", "covertype_e2e"} <= names
    for n, p in ((10240, 128), (4096, 128), (1000, 303)):
        assert {f"tile_{n}_{p}_xla", f"tile_{n}_{p}_pallas"} <= names


def test_expect_reports_and_raises(capsys):
    chip_smoke.expect("err", 1e-4, 1e-3)
    assert "ok" in capsys.readouterr().out
    with pytest.raises(AssertionError):
        chip_smoke.expect("err", 1e-2, 1e-3)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3.7e4])
def test_tile_sweep_split_is_exact(scale):
    """bench.py --tile-sweep's split-TF32 Gram splits each f32 exactly
    into a TF32 head (10-bit mantissa) and an f32 tail."""
    import numpy as np
    import jax.numpy as jnp
    x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 16)) * scale,
                    jnp.float32)
    hi, lo = bench._split_tf32(x)
    np.testing.assert_array_equal(np.asarray(hi + lo), np.asarray(x))
    assert not (np.asarray(hi).view(np.uint32) & 0x1FFF).any()
    assert np.abs(np.asarray(lo)).max() <= 2.0 ** -10 * np.abs(
        np.asarray(x)).max()


def test_tile_sweep_covers_every_gram_and_shape():
    """The sweep times the XLA path and every Gram x block variant at
    each shape that decides the tile."""
    from stein_jax.ops.pallas_svgd import _next_pow2
    names = set(bench.tile_sweep_configs())
    for n, p, _ in bench.SWEEP_SHAPES:
        assert f"sweep_{n}_{p}_xla" in names
        for gram in bench.GRAMS:
            for b in bench.SWEEP_BLOCKS[_next_pow2(p)]:
                assert (f"sweep_{n}_{p}_{gram}_{b[0]}x{b[1]}w{b[2]}s{b[3]}"
                        in names)
