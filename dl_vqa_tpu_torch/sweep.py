"""Hyperparameter sweeps of the port.

Port of the root ``sweep.py``: maximize the value returned by
:func:`dl_vqa_tpu_torch.main.main` (best validation accuracy) over a
declared search space, with ``max_trials`` and early stopping after
``max_stagnant`` trials without improvement, as the reference's Hydra-Ax
sweeper does.

The default space is the reference's active one, ``train.image.stride in
{1, 2}`` x ``train.attention.do_option in {'+', '*'}``, explored
exhaustively when the space is small (no more points than trials, where a
grid is as good as any optimizer). Larger spaces use a categorical TPE
(:mod:`dl_vqa_tpu_torch.utils.tpe`) proposing each next trial from the
good/bad density ratio of the history; ``--sampler random`` keeps seeded
random search as a baseline. The same seed gives the JAX package's
trial sequence.

    python -m dl_vqa_tpu_torch.sweep [--trials N] [--sampler tpe|random]
        [--space key=v1,v2 ...] [--device cuda] [overrides...]

Every trial trains on the GPU unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
from typing import Dict, List, Sequence, Tuple

from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["DEFAULT_SPACE", "parse_space", "space_size", "run_sweep",
           "trial_runner"]

DEFAULT_SPACE: Dict[str, List] = {
    "train.image.stride": [1, 2],
    "train.attention.do_option": ["+", "*"],
}


def parse_space(items: Sequence[str]) -> Dict[str, List]:
    """``key=v1,v2`` items -> ``{key: [v1, v2]}``, each value parsed as a
    dotlist override's value is (``config/core.py``), so that a sweep
    value is what the override would set."""
    from dl_vqa_tpu_torch.config.core import _parse_value

    space = {}
    for item in items:
        key, raw = item.split("=", 1)
        space[key] = [_parse_value(v) for v in raw.split(",")]
    return space


def space_size(space: Dict[str, List]) -> int:
    """Number of points in the cartesian space, without materializing it
    (deciding grid or TPE must not enumerate billions of points)."""
    size = 1
    for values in space.values():
        size *= len(values)
    return size


def _full_grid(space: Dict[str, List]) -> List[Dict]:
    keys = list(space)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(space[k] for k in keys))]


def _next_assignment(space: Dict[str, List], grid: List[Dict],
                     history: List[Dict], trial: int, sampler: str,
                     rng: random.Random):
    """Next point: the grid's next when the grid fits the budget, else TPE
    (model-based) or seeded random without replacement."""
    from dl_vqa_tpu_torch.utils.tpe import suggest

    if grid is not None:
        return grid[trial] if trial < len(grid) else None
    pairs = [(h["assignment"], h["value"]) for h in history]
    if sampler == "random":
        # n_startup that never ends: uniform random over untried points.
        return suggest(space, pairs, rng, n_startup=10 ** 9)
    return suggest(space, pairs, rng)


def trial_runner(config_name: str = "config", device=DEFAULT_DEVICE):
    """The default trial: ``config_name`` composed with the trial's
    overrides, trained by :func:`dl_vqa_tpu_torch.main.main` on
    ``device``; returns its best validation accuracy."""
    def runner(overrides):
        from dl_vqa_tpu_torch import config as config_mod
        from dl_vqa_tpu_torch.main import main

        return main(config_mod.compose(config_name, overrides=list(overrides)),
                    device=device)

    return runner


def run_sweep(space: Dict[str, List], max_trials: int,
              base_overrides: Sequence[str], seed: int = 0,
              max_stagnant: int = 4, runner=None,
              sampler: str = "tpe") -> Tuple[Dict, float, List]:
    """Returns ``(best_assignment, best_value, history)``. ``runner(
    overrides) -> value`` runs one trial (default: :func:`trial_runner`)."""
    if runner is None:
        runner = trial_runner()
    # None: model-based (TPE); materialized only where it fits the budget.
    grid = _full_grid(space) if space_size(space) <= max_trials else None
    rng = random.Random(seed)

    best_value, best_assignment = float("-inf"), None
    stagnant = 0
    history: List[Dict] = []
    for trial in range(max_trials):
        assignment = _next_assignment(space, grid, history, trial, sampler,
                                      rng)
        if assignment is None:  # space exhausted
            break
        overrides = list(base_overrides) + [
            f"{k}={json.dumps(v)}" for k, v in assignment.items()]
        value = float(runner(overrides))
        history.append({"trial": trial, "assignment": assignment,
                        "value": value})
        print(f"[sweep] trial {trial}: {assignment} -> {value:.4f}")
        if value > best_value:
            best_value, best_assignment = value, assignment
            stagnant = 0
        else:
            stagnant += 1
            if stagnant >= max_stagnant:
                print("[sweep] early stop: no improvement")
                break
    print(f"[sweep] best: {best_assignment} -> {best_value:.4f}")
    return best_assignment, best_value, history


def main(argv=None) -> Tuple[Dict, float, List]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--trials", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stagnant", type=int, default=4)
    parser.add_argument("--space", action="append", default=[],
                        help="key=v1,v2 (repeatable); default: the "
                             "reference space")
    parser.add_argument("--sampler", choices=("tpe", "random"),
                        default="tpe",
                        help="search strategy when the space exceeds the "
                             "trial budget (default: TPE)")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where the trials train (default: the GPU)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    space = parse_space(args.space) if args.space else DEFAULT_SPACE
    return run_sweep(space, args.trials, args.overrides, seed=args.seed,
                     max_stagnant=args.stagnant,
                     runner=trial_runner(device=args.device),
                     sampler=args.sampler)


if __name__ == "__main__":
    main()
