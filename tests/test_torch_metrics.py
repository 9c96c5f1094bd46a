"""The port's loss and metric against ``dl_vqa_tpu.ops.vqa_metrics``, on
the CPU: the same numpy inputs through both, f32, tolerance 1e-6 (a
log-softmax and a few sums of at most 40 terms in another order)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dl_vqa_tpu.ops import vqa_metrics as jax_metrics
from dl_vqa_tpu_torch.ops import vqa_metrics as port_metrics

TOL = dict(atol=1e-6, rtol=1e-6)
BATCH, ANSWERS, SLOTS = 12, 40, 10


def _inputs(seed, mask_kind):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((BATCH, ANSWERS)) * 3).astype(np.float32)
    indices = rng.integers(1, ANSWERS + 1, (BATCH, SLOTS)).astype(np.int32)
    values = rng.integers(0, 11, (BATCH, SLOTS)).astype(np.int32)
    # Padded answer slots (id 0, count 0), and one sample with no answer.
    pad = rng.random((BATCH, SLOTS)) < 0.4
    indices[pad], values[pad] = 0, 0
    indices[3], values[3] = 0, 0
    # The argmax answer is among sample 0's answers with a count above 3.
    indices[0, 0], values[0, 0] = int(logits[0].argmax()) + 1, 7
    types = rng.integers(0, 3, BATCH).astype(np.int32)
    mask = {"none": None,
            "ragged": rng.random(BATCH) < 0.6,
            "all_padded": np.zeros(BATCH, dtype=bool)}[mask_kind]
    return logits, indices, values, types, mask


def _both(fn_name, arrays, mask):
    jax_args = [jnp.asarray(a) for a in arrays]
    port_args = [torch.from_numpy(a) for a in arrays]
    expected = getattr(jax_metrics, fn_name)(
        *jax_args, None if mask is None else jnp.asarray(mask))
    got = getattr(port_metrics, fn_name)(
        *port_args, None if mask is None else torch.from_numpy(mask))
    return got, expected


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "all_padded"])
@pytest.mark.parametrize("fn_name", ["soft_cross_entropy", "vqa_accuracy_sum"])
def test_scalar_metric_matches_jax(fn_name, mask_kind):
    logits, indices, values, _, mask = _inputs(0, mask_kind)
    got, expected = _both(fn_name, (logits, indices, values), mask)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)
    if mask_kind == "all_padded":
        assert float(got) == 0.0  # the denominator is clamped to 1


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "all_padded"])
def test_accuracy_by_type_matches_jax(mask_kind):
    logits, indices, values, types, mask = _inputs(1, mask_kind)
    got, expected = _both("vqa_accuracy_by_type",
                          (logits, indices, values, types), mask)
    for g, e in zip(got, expected):
        assert g.shape == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)
    real = BATCH if mask is None else int(mask.sum())
    assert float(got[1].sum()) == real


@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_batch_stats_match_jax_and_the_parts(mask_kind):
    logits, indices, values, _, mask = _inputs(2, mask_kind)
    got, expected = _both("vqa_batch_stats", (logits, indices, values), mask)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)
    assert float(got[1]) > 0


def test_loss_is_the_counts_weighted_nll_and_ignores_masked_samples():
    logits = torch.tensor([[2.0, 0.0, -1.0], [0.5, 0.5, 0.5]])
    indices = torch.tensor([[1, 3, 0], [2, 0, 0]])
    values = torch.tensor([[6, 4, 0], [10, 0, 0]])
    log_p = torch.log_softmax(logits, dim=-1)
    per_sample = torch.stack([-(0.6 * log_p[0, 0] + 0.4 * log_p[0, 2]),
                              -log_p[1, 1]])
    loss = port_metrics.soft_cross_entropy(logits, indices, values)
    torch.testing.assert_close(loss, per_sample.mean())
    masked = port_metrics.soft_cross_entropy(
        logits, indices, values, torch.tensor([True, False]))
    torch.testing.assert_close(masked, per_sample[0])
    # 6 annotators agree with the argmax of sample 0: min(1.8, 1) = 1;
    # sample 1's argmax (id 1) is not among its answers.
    score = port_metrics.vqa_accuracy_sum(logits, indices, values)
    assert float(score) == 1.0


def test_loss_gradient_matches_jax():
    import jax

    logits, indices, values, _, mask = _inputs(3, "ragged")
    expected = jax.grad(jax_metrics.soft_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(indices), jnp.asarray(values),
        jnp.asarray(mask))
    x = torch.from_numpy(logits).requires_grad_()
    port_metrics.soft_cross_entropy(
        x, torch.from_numpy(indices), torch.from_numpy(values),
        torch.from_numpy(mask)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(expected), **TOL)
