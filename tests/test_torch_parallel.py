"""The port's 'data' axis across processes (``dl_vqa_tpu_torch.parallel``):
two gloo ranks on the CPU against the port's one-process run and against
the JAX train step on a 2-device 'data' mesh.

One module fixture runs the one-process references in this process, then
spawns two ranks (this file run by path as the worker, joined by gloo),
which run every scenario once and write what they saw: 3 steps of a small
model (convs 3 -> 4 -> 8, widths 16, 16 answers, f32, dropout 0 unless
stated) on a batch of 8 whose last batch is padded to 5 real rows (4 on
rank 0, 1 on rank 1), at ``accum_steps`` 1 and 2 and ZeRO stages 0, 1
and 3; the sharded image table against the replicated one; dropout at 0.3;
the ViT-MoE's balance loss; a ZeRO-3 checkpoint and the resumes 2 -> 1 and
1 -> 2; the eval step.

Tolerances: the ranks sum their gradients in another order than one
process does (two partial sums and an all-reduce), so losses, scores and
the Adam moments (linear and quadratic in the gradients) are held at rtol
1e-5, atol 1e-6, as ``tests/test_multihost.py`` holds JAX's ranks. The
parameters are not held there: Adam's step ``LR * m / (sqrt(v) + eps)``
turns the rounding of a gradient that lies within a few ``eps`` (1e-8) of
zero at some step into a change of up to LR in the parameter. They are
held at atol 1e-4 (a tenth of LR; 5.1e-5 was seen after 3 steps, and the
JAX package's own run on 1 and on 2 'data' devices differed by 4.8e-5)
where the gradient is clear of rounding noise (a root-mean-square gradient
above 1e-6, read from the reference run's second moment), and elsewhere
(the glimpse bias, whose gradient is zero by the softmax's shift
invariance) within Adam's bound of LR a step. What is run the same way on
both sides is held to the bit: the ZeRO stages against stage 0 at two
ranks, the sharded image table against the replicated one.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLD = 2
BATCH = 8
LR = 1e-3
STEPS = 3
TABLE_ROWS = 11
TOL = {"rtol": 1e-5, "atol": 1e-6}
PARAM_ATOL = 1e-4
# Against the JAX step, whose f32 gradients differ from the port's by up to
# 1e-4 relative (tests/test_torch_train.py), half an Adam step, as
# test_torch_train.py's 50-step test holds the two packages.
JAX_PARAM_ATOL = 5e-4


def _cfg_dict(dropout=0.0, moe=0):
    image = {"num_channels": [3, 4, 8], "dropout": dropout}
    if moe:
        image.update(encoder="vit", num_channels=[3, 64], patch_size=8,
                     num_layers=1, num_heads=1, moe_experts=moe)
    return {"text": {"question_features": 16, "embedding_features": 8,
                     "dropout": dropout},
            "image": image,
            "attention": {"hidden_dim": 16, "glimpses": 2,
                          "dropout": dropout},
            "classifier": {"hidden_dim": 16, "dropout": dropout},
            "max_answers": 16, "image_size": 32, "num_tokens": 30}


def _port_cfg(**kw):
    from dl_vqa_tpu_torch.models.configs import ModelConfig

    return ModelConfig.from_meta_dict(_cfg_dict(**kw))


def _batches(seed=0, table=False):
    """Three global batches; the last padded to 5 real rows."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(STEPS):
        lengths = rng.integers(1, 7, BATCH).astype(np.int32)
        questions = rng.integers(0, 30, (BATCH, 6)).astype(np.int32)
        questions *= np.arange(6)[None, :] < lengths[:, None]
        batch = {
            "questions": questions,
            "lengths": lengths,
            "answer_indices": rng.integers(1, 17, (BATCH, 4)).astype(
                np.int32),
            "answer_values": rng.integers(1, 11, (BATCH, 4)).astype(
                np.int32),
            "answer_types": rng.integers(0, 3, BATCH).astype(np.int32),
            "mask": np.arange(BATCH) < (5 if step == STEPS - 1 else BATCH),
        }
        if table:
            batch["image_rows"] = rng.integers(0, TABLE_ROWS, BATCH).astype(
                np.int32)
        else:
            batch["images"] = rng.standard_normal(
                (BATCH, 32, 32, 3)).astype(np.float32)
        out.append(batch)
    return out


def _table():
    rng = np.random.default_rng(5)
    return rng.standard_normal((TABLE_ROWS, 32, 32, 3)).astype(np.float16)


def _fresh_state(cfg, mesh=None, stage=0, restore=None):
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.parallel.zero import parallelize
    from dl_vqa_tpu_torch.train import create_train_state
    from dl_vqa_tpu_torch.utils.checkpoint import restore_state

    model = VqaNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    if hasattr(model.text, "lstm"):
        model.text.lstm.fold_biases()
    state = create_train_state(model, LR, device="cpu")
    if restore:
        state, _ = restore_state(state, restore)
    if mesh is not None:
        state = parallelize(state, mesh, stage)
    return state


def _rows(batch, mesh, accum=1):
    if mesh is None:
        return batch
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice

    rows = process_batch_slice(mesh, BATCH, accum)
    return {key: value[rows] for key, value in batch.items()}


def _train(cfg, batches, mesh=None, stage=0, accum=1, table=None,
           state=None, steps=None):
    """Losses, scores (and MoE balance losses) of ``batches`` and the
    state after them."""
    from dl_vqa_tpu_torch.train import make_train_step

    state = state or _fresh_state(cfg, mesh, stage)
    step = make_train_step(cfg, torch.float32, accum_steps=accum, mesh=mesh)
    out = {"loss": [], "score": [], "moe_aux": []}
    for batch in batches[:steps]:
        batch = _rows(batch, mesh, accum)
        if table is not None:
            batch = dict(batch, image_table=table)
        state, metrics = step(state, batch, 7)
        for key in out:
            if key in metrics:
                out[key].append(float(metrics[key]))
    return out, state


def _snapshot(state):
    from dl_vqa_tpu_torch.utils.checkpoint import host_snapshot

    return host_snapshot(state)


def _eval(cfg, batches, model, mesh=None):
    from dl_vqa_tpu_torch.train import make_eval_step

    step = make_eval_step(cfg, torch.float32, with_breakdown=True, mesh=mesh)
    out = []
    for batch in batches:
        loss, score, sums, counts = step(model, _rows(batch, mesh))
        out.append([float(loss), float(score)] + sums.tolist()
                   + counts.tolist())
    return out


# ------------------------------------------------------------ the worker

def _worker(rank, port, out_dir, resume_from):
    """One rank: every scenario, then ``rank{r}.json`` (numbers) and, on
    rank 0, ``arrays.npz`` (the gathered states)."""
    import torch.distributed as dist

    from dl_vqa_tpu_torch.data.device_cache import ShardedImageTable
    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.parallel.multihost import process_dim0_block
    from dl_vqa_tpu_torch.parallel.zero import moments_held
    from dl_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    mesh = make_mesh(-1, device_type="cpu")
    numbers, arrays = {"rank": rank, "world": dist.get_world_size()}, {}

    def keep(name, out, state):
        numbers[name] = out
        numbers[name + "/held"] = moments_held(state)
        snap = _snapshot(state)
        if rank == 0:
            arrays.update({f"{name}/{k}": v for k, v in snap.items()})

    cfg = _port_cfg()
    batches = _batches()
    for accum in (1, 2):
        for stage in (0, 1, 3):
            out, state = _train(cfg, batches, mesh, stage, accum)
            keep(f"a{accum}_z{stage}", out, state)
    out, state = _train(_port_cfg(dropout=0.3), batches, mesh, 0, 1)
    keep("dropout_a1", out, state)
    out, state = _train(_port_cfg(dropout=0.3), batches, mesh, 0, 2)
    keep("dropout_a2", out, state)

    # The image table: replicated against sharded, to the bit.
    table = torch.from_numpy(_table())
    block = process_dim0_block(mesh, table.shape)
    sharded = ShardedImageTable(table[block].clone(), block.start,
                                TABLE_ROWS, mesh)
    tbatches = _batches(seed=3, table=True)
    gathered = [sharded.index_select(
        0, torch.from_numpy(_rows(b, mesh)["image_rows"])) for b in tbatches]
    numbers["table_gather_bits"] = all(
        torch.equal(g.view(torch.int16),
                    table[torch.from_numpy(_rows(b, mesh)["image_rows"])
                          .long()].view(torch.int16))
        for g, b in zip(gathered, tbatches))
    for layout, t in (("replicated", table), ("sharded", sharded)):
        out, state = _train(cfg, tbatches, mesh, 0, 1, table=t)
        keep(f"table_{layout}", out, state)

    out, state = _train(_port_cfg(moe=4), _batches(seed=4), mesh, 0, 1)
    keep("moe", out, state)
    out, state = _train(_port_cfg(moe=4), _batches(seed=4), mesh, 0, 2)
    keep("moe_a2", out, state)

    # ZeRO-3: a checkpoint after two steps (the coordinator writes, every
    # rank gathers), its third step; and the one-process checkpoint of
    # step 2 resumed at two ranks.
    out, state = _train(cfg, batches, mesh, 3, 1, steps=2)
    path = os.path.join(out_dir, "zero3_step2.ckpt")
    if rank == 0:
        save_checkpoint(path, state, epoch=0)
    else:
        _snapshot(state)  # the coordinator's gather
    dist.barrier()
    out3, _ = _train(cfg, batches[2:], mesh, state=state)
    numbers["zero3_steps"] = {"loss": out["loss"] + out3["loss"]}
    resumed = _fresh_state(cfg, mesh, 3, restore=resume_from)
    numbers["resume_1_to_2"] = _train(cfg, batches[2:], mesh,
                                      state=resumed)[0]
    numbers["resume_1_to_2/step"] = resumed.step

    numbers["eval"] = _eval(cfg, batches, _fresh_state(cfg, mesh, 3).model,
                            mesh)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(numbers, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------ the fixture

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references, then the two ranks' results."""
    from dl_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    cfg = _port_cfg()
    batches = _batches()
    single = {}
    for accum in (1, 2):
        out, state = _train(cfg, batches, accum=accum)
        single[f"a{accum}"] = (out, _snapshot(state))
    for accum in (1, 2):
        out, state = _train(_port_cfg(dropout=0.3), batches, accum=accum)
        single[f"dropout_a{accum}"] = (out, _snapshot(state))
    out, state = _train(_port_cfg(moe=4), _batches(seed=4))
    single["moe"] = (out, _snapshot(state))
    out, state = _train(_port_cfg(moe=4), _batches(seed=4), accum=2)
    single["moe_a2"] = (out, _snapshot(state))
    out, state = _train(cfg, batches, steps=2)
    resume_from = os.path.join(out_dir, "single_step2.ckpt")
    save_checkpoint(resume_from, state, epoch=0)
    single["step2"] = _snapshot(state)
    single["eval"] = _eval(cfg, batches, _fresh_state(cfg).model)

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, HERE, "--worker", str(rank), str(port), out_dir,
         resume_from], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO, env=env) for rank in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(WORLD)]
    with np.load(os.path.join(out_dir, "arrays.npz")) as data:
        arrays = {key: data[key] for key in data.files}
    return {"single": single, "ranks": ranks, "arrays": arrays,
            "dir": out_dir, "batches": batches}


def _state_of(arrays, name):
    head = name + "/"
    return {k[len(head):]: v for k, v in arrays.items() if k.startswith(head)}


def _clear(reference, key):
    """Entries of ``key`` (a ``params|...`` array) whose gradient is clear
    of rounding noise, read from the reference state's Adam second
    moment."""
    nu = reference["opt_state|#0|nu|" + key[len("params|"):]]
    count = int(reference["opt_state|#0|count"])
    return np.sqrt(nu / (1.0 - 0.999 ** count)) > 1e-6


def _assert_states_close(got, expected, steps, what, param_atol=PARAM_ATOL):
    """Every array of two flat checkpoint states: the moments and counts
    at :data:`TOL`; the parameters at :data:`PARAM_ATOL` where the
    gradient is clear of noise (module docstring). Elsewhere they are held
    only to Adam's bound of ``steps * LR`` a side, a sanity bound that two
    Adam runs from one start cannot exceed: it catches a NaN or a
    parameter no update reached, not a wrong gradient."""
    assert got.keys() == expected.keys(), what
    compared = total = 0
    for key, want in expected.items():
        if key.startswith("params|"):
            clear = _clear(expected, key)
            compared += int(clear.sum())
            total += clear.size
            np.testing.assert_allclose(got[key][clear], want[clear],
                                       rtol=TOL["rtol"], atol=param_atol,
                                       err_msg=f"{what}: {key}")
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=2 * steps * LR,
                                       err_msg=f"{what}: {key}")
        else:
            np.testing.assert_allclose(got[key], want, **TOL,
                                       err_msg=f"{what}: {key}")
    assert compared > 0.8 * total, what


# ------------------------------------------------------------ the tests

def test_the_ranks_report_the_same_global_numbers(runs):
    r0, r1 = runs["ranks"]
    assert r0["world"] == r1["world"] == WORLD
    for name in r0:
        if name in ("rank",) or name.endswith("/held"):
            continue
        assert r0[name] == r1[name], name


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_equal_one_process(runs, accum):
    """Losses, scores and the state after 3 steps, the padded last batch
    giving the ranks 4 and 1 real rows: each rank divides its sum by the
    global real count, so the global loss is not the mean of the ranks'
    means."""
    expected, expected_state = runs["single"][f"a{accum}"]
    got = runs["ranks"][0][f"a{accum}_z0"]
    for key in ("loss", "score"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=key)
    _assert_states_close(_state_of(runs["arrays"], f"a{accum}_z0"),
                         expected_state, STEPS, f"accum {accum}")
    # A mean of per-rank means would be another number on the last batch.
    batch = runs["batches"][-1]
    assert batch["mask"][:4].sum() == 4 and batch["mask"][4:].sum() == 1


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("accum", [1, 2])
def test_zero_stages_equal_stage_0_and_hold_a_share(runs, stage, accum):
    """ZeRO-1 splits the Adam moments over the ranks, ZeRO-3 the
    parameters too: each rank holds at most half of them (plus FSDP2's
    padding of a dim 0 that does not halve), and the numbers are stage
    0's to the bit: at two ranks every reduction adds the same two
    partial gradients, and Adam is elementwise however its tensors are
    split."""
    ranks = runs["ranks"]
    got, base = ranks[0][f"a{accum}_z{stage}"], ranks[0][f"a{accum}_z0"]
    assert got == base
    expected = _state_of(runs["arrays"], f"a{accum}_z0")
    state = _state_of(runs["arrays"], f"a{accum}_z{stage}")
    assert state.keys() == expected.keys()
    for key, value in expected.items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)
    whole_moments, whole_params = ranks[0][f"a{accum}_z0/held"]
    assert whole_moments == 2 * whole_params
    for rank in ranks:
        moments, params = rank[f"a{accum}_z{stage}/held"]
        assert moments <= whole_moments / WORLD + 2 * 64, rank["rank"]
        if stage == 3:
            assert params <= whole_params / WORLD + 64, rank["rank"]
        else:
            assert params == whole_params
    assert sum(r[f"a{accum}_z{stage}/held"][0] for r in ranks) >= \
        whole_moments


def test_the_sharded_table_gives_the_replicated_bits(runs):
    """Each rank holds 6 or 5 of the 11 rows; a batch's images, and with
    them every loss and parameter, are the replicated table's bits."""
    rank0 = runs["ranks"][0]
    assert rank0["table_gather_bits"] and runs["ranks"][1][
        "table_gather_bits"]
    assert rank0["table_sharded"] == rank0["table_replicated"]
    sharded = _state_of(runs["arrays"], "table_sharded")
    replicated = _state_of(runs["arrays"], "table_replicated")
    for key, value in replicated.items():
        np.testing.assert_array_equal(sharded[key], value, err_msg=key)


def test_the_eval_step_sums_over_the_ranks(runs):
    """Loss (sum over the ranks' real rows / global count), score and the
    per-type sums and counts of the one-process eval step."""
    np.testing.assert_allclose(runs["ranks"][0]["eval"],
                               runs["single"]["eval"], **TOL)


def test_a_zero3_checkpoint_is_the_one_process_checkpoint(runs):
    """The file two ZeRO-3 ranks write after 2 steps (the coordinator
    writes what every rank gathered) holds the one-process arrays."""
    from dl_vqa_tpu_torch.utils.checkpoint import load_checkpoint

    flat, meta = load_checkpoint(os.path.join(runs["dir"],
                                              "zero3_step2.ckpt"))
    assert meta["epoch"] == 0 and int(flat["step"]) == 2
    _assert_states_close(flat, runs["single"]["step2"], 2, "zero3 ckpt")


def test_resumes_across_world_sizes_continue_the_unbroken_run(runs):
    """2 -> 1: the two ranks' ZeRO-3 checkpoint restored in one process
    takes step 3 as the unbroken run does; 1 -> 2: the one-process
    checkpoint restored at two ranks under ZeRO-3 does too."""
    unbroken = runs["single"]["a1"][0]["loss"]
    cfg = _port_cfg()
    state = _fresh_state(cfg, restore=os.path.join(runs["dir"],
                                                   "zero3_step2.ckpt"))
    assert state.step == 2
    out, _ = _train(cfg, runs["batches"][2:], state=state)
    np.testing.assert_allclose(out["loss"], unbroken[2:], **TOL)
    rank0 = runs["ranks"][0]
    assert rank0["resume_1_to_2/step"] == STEPS
    np.testing.assert_allclose(rank0["resume_1_to_2"]["loss"],
                               unbroken[2:], **TOL)
    np.testing.assert_allclose(rank0["zero3_steps"]["loss"], unbroken,
                               **TOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_each_rank_draws_its_rows_of_the_one_process_masks(runs, accum):
    """Dropout 0.3: the JAX step's masks do not depend on how its batch is
    sharded (``test_jax_dropout_does_not_depend_on_the_data_axis``), so
    each rank draws the one-process masks of the global batch (or of the
    global micro-batch its rows lie in) and keeps its rows: the losses are
    the one-process run's."""
    expected, expected_state = runs["single"][f"dropout_a{accum}"]
    got = runs["ranks"][0][f"dropout_a{accum}"]
    for key in ("loss", "score"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=key)
    _assert_states_close(_state_of(runs["arrays"], f"dropout_a{accum}"),
                         expected_state, STEPS, f"dropout accum {accum}")


# ------------------------------------------------------- against JAX

def _jax_run(cfg_dict, params, batches, devices, accum=1):
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.models.configs import ModelConfig as JaxModelConfig
    from dl_vqa_tpu.parallel import batch_sharding, make_mesh, replicated
    from dl_vqa_tpu.train.state import create_train_state
    from dl_vqa_tpu.train.steps import make_optimizer, make_train_step

    cfg = JaxModelConfig.from_meta_dict(cfg_dict)
    mesh = make_mesh(data=devices, model=1, devices=jax.devices()[:devices])
    tx = make_optimizer(LR)
    state = jax.device_put(create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx), replicated(mesh))
    step = make_train_step(cfg, tx, compute_dtype=jnp.float32,
                           accum_steps=accum)
    out = {"loss": [], "score": [], "moe_aux": []}
    for batch in batches:
        placed = {k: jax.device_put(v, batch_sharding(mesh))
                  for k, v in batch.items()}
        state, metrics = step(state, placed, jax.random.PRNGKey(0))
        for key in out:
            if key in metrics:
                out[key].append(float(metrics[key]))
    return out, state


def _initial_params(cfg):
    from dl_vqa_tpu_torch.utils.params import jax_params_from_model

    return jax_params_from_model(_fresh_state(cfg).model)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_equal_jax_on_a_2_device_data_mesh(runs, accum):
    """The same initial parameters (the port's, through
    ``utils/params.py``) and batches through the JAX train step on a
    'data' mesh of 2 virtual devices: the ranks' losses and scores at
    :data:`TOL`, and their state, in the checkpoint layout both packages
    write, as :func:`_assert_states_close` holds it."""
    from dl_vqa_tpu.utils.checkpoint import _flatten

    expected, state = _jax_run(_cfg_dict(), _initial_params(_port_cfg()),
                               runs["batches"], WORLD, accum)
    got = runs["ranks"][0][f"a{accum}_z0"]
    for key in ("loss", "score"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=key)
    _assert_states_close(_state_of(runs["arrays"], f"a{accum}_z0"),
                         _flatten(state), STEPS, "against JAX",
                         param_atol=JAX_PARAM_ATOL)


def test_the_moe_balance_loss_at_two_ranks_is_jaxs(runs):
    """``config_vit_moe``'s block at a small size (one ViT block, 4
    experts, top-2): the ranks take the balance loss's first-choice
    fractions over both ranks' tokens, so the loss, ``moe_aux`` and score
    of each step are the JAX step's on a 2-device 'data' mesh and the
    one-process run's."""
    expected, _ = _jax_run(_cfg_dict(moe=4), _initial_params(
        _port_cfg(moe=4)), _batches(seed=4), WORLD)
    got = runs["ranks"][0]["moe"]
    single = runs["single"]["moe"][0]
    assert len(got["moe_aux"]) == STEPS
    for key in ("loss", "score", "moe_aux"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key], single[key], **TOL,
                                   err_msg=key)


def test_the_moe_balance_loss_at_two_ranks_and_two_micro_batches_is_jaxs(
        runs):
    """The same block at ``accum_steps=2``: JAX's micro-batch k is the
    contiguous global rows ``[4 k, 4 k + 4)``, and each rank holds its half
    of every global micro-batch (``process_batch_slice(mesh, 8, 2)``), so
    the balance loss, a product of per-micro-batch means, takes JAX's
    token sets: loss, ``moe_aux`` and score at :data:`TOL` against the JAX
    step on a 2-device 'data' mesh and the one-process run."""
    expected, _ = _jax_run(_cfg_dict(moe=4), _initial_params(
        _port_cfg(moe=4)), _batches(seed=4), WORLD, accum=2)
    got = runs["ranks"][0]["moe_a2"]
    single = runs["single"]["moe_a2"][0]
    assert len(got["moe_aux"]) == STEPS
    for key in ("loss", "score", "moe_aux"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key], single[key], **TOL,
                                   err_msg=key)


def test_jax_dropout_does_not_depend_on_the_data_axis():
    """The reference check behind the port's masks: the JAX train step at
    dropout 0.3 gives the same losses on 1 and on 2 'data' devices (its
    random bits are a function of the key and the global shape)."""
    cfg = _cfg_dict(dropout=0.3)
    params = _initial_params(_port_cfg(dropout=0.3))
    one, _ = _jax_run(cfg, params, _batches(), 1)
    two, _ = _jax_run(cfg, params, _batches(), WORLD)
    np.testing.assert_allclose(two["loss"], one["loss"], **TOL)
    np.testing.assert_allclose(two["score"], one["score"], **TOL)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
