"""The port's sweeps (``dl_vqa_tpu_torch.sweep``), its TPE copy and
``main.py -m`` (``dl_vqa_tpu_torch.main.multirun_main``), on the CPU: the
same trial sequence as the JAX package's ``sweep.run_sweep`` on seeded
synthetic surfaces, the checks of ``tests/test_sweep.py`` on the port, and
one real sweep of two trials trained by the port's ``main``."""

import glob
import os
import sys

import pytest

from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu_torch import main as port_main
from dl_vqa_tpu_torch import sweep as port_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_sweep():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import sweep as jax_sweep

    return jax_sweep


def _surface(space, seed):
    """A separable response surface over ``space``, each key's scores
    permuted by the seed; the runner reads the trial's overrides."""
    keys = list(space)
    perm = {k: [(j * (7 + seed) + i) % len(space[k])
                for j in range(len(space[k]))] for i, k in enumerate(keys)}
    scores = [0.0, 1.0, 2.0, 5.0, 3.0, 0.5]

    def runner(overrides):
        a = {o.split("=")[0]: o.split("=")[1] for o in overrides}
        return sum(scores[perm[k][[str(v) for v in space[k]].index(a[k])]]
                   for k in keys)

    return runner


@pytest.mark.parametrize("sampler", ["tpe", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trial_sequence_equals_the_jax_package_s(sampler, seed, capsys):
    """TPE and random search over a 4^5 space with 25 trials: the port's
    sweep proposes the JAX package's assignments in the same order and
    stops where it stops, on the same seed."""
    space = {f"k{i}": [0, 1, 2, 3] for i in range(5)}
    runs = [sweeps.run_sweep(space, max_trials=25, base_overrides=[],
                             seed=seed, max_stagnant=6,
                             runner=_surface(space, seed), sampler=sampler)
            for sweeps in (_jax_sweep(), port_sweep)]
    assert runs[0] == runs[1]
    assert len(runs[0][2]) > 4
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert printed[:half] == printed[half:]


def test_grid_when_space_fits():
    space = {"a": [1, 2], "b": ["x", "y"]}
    _, _, history = port_sweep.run_sweep(
        space, max_trials=4, base_overrides=[], max_stagnant=99,
        runner=lambda overrides: 0.0)
    tried = {tuple(sorted(h["assignment"].items())) for h in history}
    assert len(history) == 4 and len(tried) == 4
    assert [h["assignment"] for h in history] == [
        h["assignment"] for h in _jax_sweep().run_sweep(
            space, max_trials=4, base_overrides=[], max_stagnant=99,
            runner=lambda overrides: 0.0)[2]]


def test_random_sampler_draws_distinct_points():
    space = {"a": list(range(10)), "b": list(range(10))}
    _, _, history = port_sweep.run_sweep(
        space, max_trials=5, base_overrides=[], seed=1, max_stagnant=99,
        runner=lambda overrides: 0.0, sampler="random")
    tried = {tuple(sorted(h["assignment"].items())) for h in history}
    assert len(history) == 5 and len(tried) == 5


def test_run_sweep_maximizes():
    calls = []

    def fake_runner(overrides):
        calls.append(list(overrides))
        stride = next(int(o.split("=")[1]) for o in overrides
                      if o.startswith("train.image.stride"))
        opt = next(o.split("=")[1] for o in overrides
                   if o.startswith("train.attention.do_option"))
        return 10.0 * stride + (5.0 if '"*"' in opt else 0.0)

    best, value, history = port_sweep.run_sweep(
        port_sweep.DEFAULT_SPACE, max_trials=4,
        base_overrides=["main.seed=1"], runner=fake_runner)
    assert best == {"train.image.stride": 2,
                    "train.attention.do_option": "*"}
    assert value == 25.0 and len(history) == 4
    assert all("main.seed=1" in c for c in calls)


def test_early_stop_on_stagnation():
    values = iter([5.0, 1.0, 1.0, 1.0, 9.0])
    _, value, history = port_sweep.run_sweep(
        {"a": [1, 2, 3, 4, 5]}, max_trials=5, base_overrides=[],
        max_stagnant=2, runner=lambda _: next(values))
    assert value == 5.0
    assert len(history) == 3  # stopped before the 9.0 trial


@pytest.mark.parametrize("items", [
    ["train.image.stride=1,2", "x=a,b"],
    ["train.lr.lr_value=5e-4,1.0e-3,2", "flag=true,off,null"],
])
def test_parse_space_reads_values_as_the_jax_package(items):
    space = port_sweep.parse_space(items)
    assert space == _jax_sweep().parse_space(items)
    assert {k: [type(v) for v in vs] for k, vs in space.items()} == {
        k: [type(v) for v in vs]
        for k, vs in _jax_sweep().parse_space(items).items()}


def test_space_size_without_materialization():
    huge = {f"k{i}": list(range(10)) for i in range(10)}  # 10^10 points
    assert port_sweep.space_size(huge) == 10 ** 10
    calls = []

    def fake_runner(overrides):
        calls.append(overrides)
        return float(len(calls))

    _, _, history = port_sweep.run_sweep(huge, max_trials=3,
                                         base_overrides=[],
                                         runner=fake_runner,
                                         sampler="random")
    assert len(history) == 3


def test_multirun_main_hydra_style():
    """``-m key=a,b fixed=v``: comma values span the space, bracketed
    lists stay single values, fixed overrides reach every trial."""
    calls = []

    def fake_runner(overrides):
        calls.append(list(overrides))
        return float(next(int(o.split("=")[1]) for o in overrides
                          if o.startswith("train.image.stride")))

    best = port_main.multirun_main(
        "config", ["train.image.stride=1,2",
                   "train.image.num_channels=[3, 8]", "main.seed=7"],
        runner=fake_runner)
    assert best == 2.0 and len(calls) == 2
    assert all("main.seed=7" in c for c in calls)
    assert all("train.image.num_channels=[3, 8]" in c for c in calls)


def test_multirun_main_requires_choice():
    with pytest.raises(SystemExit, match="comma-valued"):
        port_main.multirun_main("config", ["main.seed=1"],
                                runner=lambda o: 0.0)
    with pytest.raises(SystemExit, match="stray_flag"):
        port_main.multirun_main("config", ["stray_flag", "a=1,2"],
                                runner=lambda o: 0.0)
    with pytest.raises(SystemExit, match="--trials needs an integer"):
        port_main.multirun_main("config", ["a=1,2", "--trials", "x"],
                                runner=lambda o: 0.0)


def test_multirun_trials_flag_and_full_grid_default():
    calls = []

    def fake_runner(overrides):
        calls.append(list(overrides))
        return float(len(calls))

    port_main.multirun_main("config", ["a=1,2,3"], runner=fake_runner)
    assert len(calls) == 3
    calls.clear()
    port_main.multirun_main("config", ["a=1,2,3", "--trials", "2"],
                            runner=fake_runner)
    assert len(calls) == 2


def test_sweep_command_line_runs_the_sweep(monkeypatch):
    """``python -m dl_vqa_tpu_torch.sweep --space ... --trials N`` runs
    the sweep with the trial of ``trial_runner(device=...)``."""
    asked = []

    def fake_trial_runner(config_name="config", device="cuda"):
        asked.append((config_name, device))
        return lambda overrides: float(next(
            int(o.split("=")[1]) for o in overrides if o.startswith("a=")))

    monkeypatch.setattr(port_sweep, "trial_runner", fake_trial_runner)
    best, value, history = port_sweep.main(
        ["--space", "a=1,3,2", "--trials", "3", "--device", "cpu",
         "main.seed=3"])
    assert asked == [("config", "cpu")]
    assert best == {"a": 3} and value == 3.0 and len(history) == 3


def test_multirun_main_trains_each_trial_on_the_cpu(tmp_path):
    """A real sweep: two learning rates, one epoch each, trained by the
    port's ``main`` on the CPU at tiny widths; the best returned is the
    larger of the trials' best accuracies, each trial its own run."""
    from tests.test_torch_entry import _overrides

    profile = jax_synthetic.make_synthetic_corpus(
        str(tmp_path / "corpus"), n_train=32, n_val=16, n_images=4,
        image_size=24, max_answers=12, learnable=True)
    trial = port_sweep.trial_runner("config", "cpu")
    values = []

    def recorded(overrides):
        values.append(trial(overrides))
        return values[-1]

    best = port_main.multirun_main(
        "config", ["train.lr.lr_value=5.0e-4,3.0e-3",
                   *_overrides(profile, tmp_path), "train.num_epochs=1"],
        runner=recorded, device="cpu")
    assert len(values) == 2 and best == max(values)
    assert all(0.0 <= v <= 100.0 for v in values)
    assert len(glob.glob(str(tmp_path / "logs" / "final_model_*"))) == 2
