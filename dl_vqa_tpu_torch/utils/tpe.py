"""Tree-structured Parzen Estimator (TPE) for discrete search spaces.

Model-based replacement for the reference's Hydra-Ax Bayesian sweeper
(its ``config/config.yaml``, lines 91-132): given a history of
(assignment, value) trials, split it at the top-``gamma`` quantile into
good/bad sets, model each key's value distribution in both sets with
Laplace-smoothed categorical densities, and propose the untried candidate
maximizing ``log p(x | good) - log p(x | bad)`` (the expected-improvement
surrogate of Bergstra et al., NeurIPS 2011, specialized to categorical
dimensions — the only kind the VQA sweep space has).

Dependency-free (stdlib only); the sweeps
(:mod:`dl_vqa_tpu_torch.sweep`) sequences it against ``main() -> best
accuracy``. The port's copy of ``dl_vqa_tpu/utils/tpe.py``, held to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import itertools
import math
import random
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["suggest"]

# Exhaustively score the candidate grid when it is no bigger than this;
# otherwise score a random sample of candidates (classic TPE also samples).
_MAX_ENUMERATED_GRID = 4096
_N_SAMPLED_CANDIDATES = 256


def _grid(space: Dict[str, List]) -> List[Tuple]:
    keys = list(space)
    return list(itertools.product(*(space[k] for k in keys)))


def _candidate_pool(space: Dict[str, List], rng: random.Random) -> List[Tuple]:
    size = 1
    for values in space.values():
        size *= len(values)
    if size <= _MAX_ENUMERATED_GRID:
        return _grid(space)
    return [
        tuple(rng.choice(space[k]) for k in space)
        for _ in range(_N_SAMPLED_CANDIDATES)
    ]


def _log_density(subset: List[Dict], key: str, value, n_choices: int,
                 smoothing: float) -> float:
    counts = Counter(h[key] for h in subset)
    return math.log(
        (counts[value] + smoothing)
        / (len(subset) + smoothing * n_choices)
    )


def suggest(
    space: Dict[str, List],
    history: Sequence[Tuple[Dict, float]],
    rng: random.Random,
    n_startup: int = 4,
    gamma: float = 0.25,
    smoothing: float = 1.0,
) -> Optional[Dict]:
    """Propose the next assignment to evaluate.

    ``history`` is a sequence of ``(assignment_dict, value)`` with higher
    values better. The first ``n_startup`` proposals are uniform random
    (TPE needs observations before its densities mean anything). Returns
    ``None`` when every point of an enumerable space has been tried.
    """
    keys = list(space)
    tried = {tuple(a[k] for k in keys) for a, _ in history}

    # For sampled (non-enumerable) spaces a single 256-draw pool can by
    # bad luck consist entirely of already-tried points — that means
    # "resample", not "space exhausted" (thousands of untried points
    # remain). Retry a few rounds before giving up; enumerable spaces
    # exhaust for real on the first round (the pool IS the grid).
    size = 1
    for values in space.values():
        size *= len(values)
    untried: List[Tuple] = []
    for _ in range(1 if size <= _MAX_ENUMERATED_GRID else 16):
        pool = _candidate_pool(space, rng)
        untried = [c for c in pool if c not in tried]
        if untried:
            break
    if not untried:
        return None

    if len(history) < n_startup:
        return dict(zip(keys, rng.choice(untried)))

    ranked = sorted(history, key=lambda av: av[1], reverse=True)
    n_good = max(1, math.ceil(gamma * len(ranked)))
    good = [a for a, _ in ranked[:n_good]]
    bad = [a for a, _ in ranked[n_good:]]

    def score(candidate: Tuple) -> float:
        total = 0.0
        for key, value in zip(keys, candidate):
            n = len(space[key])
            total += _log_density(good, key, value, n, smoothing)
            total -= _log_density(bad, key, value, n, smoothing)
        return total

    # Shuffle first so ties break randomly rather than in grid order.
    rng.shuffle(untried)
    return dict(zip(keys, max(untried, key=score)))
