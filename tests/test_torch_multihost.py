"""The port's multi-process tier (``dl_vqa_tpu_torch.parallel.mesh`` and
``.multihost``): the mesh and its refusals, each rank's rows against the
JAX package's 'data' sharding and ``Batcher(process_slice=...)``,
torchrun's environment, the ``zero_stage`` checks, and the entry points
as two processes.

One module fixture runs ``main`` for one epoch and ``evaluate_vqa`` in
this process on the port's synthetic corpus, then launches this file by
path as two ranks with torchrun's environment (gloo on the CPU), each of
which runs ``main`` at ZeRO stages 0 (table replicated), 1 (table
sharded) and 3 (no table) and ``evaluate_vqa`` on the stage-0 run's
checkpoint; then ``torchrun`` launches ``python -m dl_vqa_tpu_torch.main
--device cpu`` itself as two ranks at ZeRO 3. Batch 16 over two ranks of
8 rows; the last batch's real rows
fall unevenly over them. Per-step losses and scores at rtol 1e-5, atol
1e-6, as ``tests/test_multihost.py`` holds JAX's ranks.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.parallel import make_mesh, multihost
from dl_vqa_tpu_torch.parallel.mesh import Mesh

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLD = 2
BATCH = 16
TOL = {"rtol": 1e-5, "atol": 1e-6}
# Per ZeRO stage, the image table the two-rank run uses.
TABLES = {0: ["tpu.device_image_cache=on"],
          1: ["tpu.device_image_cache=on",
              "tpu.device_image_cache_layout=sharded"],
          3: ["tpu.device_image_cache=off"]}


# ------------------------------------------------------------ the mesh

def test_the_mesh_takes_the_world_and_refuses_oversubscription():
    """In one process ``data=-1`` takes the one device, and a mesh of more
    raises the JAX package's message for the same numbers (at two ranks:
    :func:`test_the_mesh_over_two_ranks`)."""
    import jax

    from dl_vqa_tpu.parallel import make_mesh as jax_make_mesh

    assert make_mesh(device_type="cpu").shape == {"data": 1, "model": 1}
    assert make_mesh(-1).device_mesh is None  # no group
    with pytest.raises(ValueError) as port_error:
        make_mesh(16)
    with pytest.raises(ValueError) as jax_error:
        jax_make_mesh(data=16, model=1, devices=jax.devices()[:1])
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("axis", ["model", "stage", "expert", "seq"])
def test_the_axes_still_missing_raise_naming_item_9(axis):
    """Every axis is ported: in one process an axis of 2 raises the JAX
    package's oversubscription message for the same numbers ('stage' and
    'seq' together raise the JAX model's error:
    ``tests/test_torch_sequence.py``)."""
    import jax

    from dl_vqa_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError) as port_error:
        make_mesh(-1, **{axis: 2})
    with pytest.raises(ValueError) as jax_error:
        jax_make_mesh(-1, devices=jax.devices()[:1], **{axis: 2})
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_each_rank_holds_the_rows_of_jaxs_data_shard(n):
    """Rank ``r`` of ``n`` holds the rows JAX's 'data' sharding over the
    first ``n`` of the conftest's virtual devices puts on device ``r``: a
    batch of 16, and a table of 11 rows, which the JAX package pads to a
    multiple of ``n`` before it shards it (``data/device_cache.py``), so
    its last shards are short or empty. In one JAX process,
    ``process_dim0_block`` is the union of the shards, which the ranks'
    blocks tile."""
    import jax

    from dl_vqa_tpu.parallel import batch_sharding
    from dl_vqa_tpu.parallel import make_mesh as jax_make_mesh
    from dl_vqa_tpu.parallel.multihost import (
        process_dim0_block as jax_block)

    mesh = jax_make_mesh(data=n, model=1, devices=jax.devices()[:n])
    sharding = batch_sharding(mesh)
    for rows in (BATCH, 11):
        padded = -(-rows // n) * n
        shards = sharding.devices_indices_map((padded,))
        blocks = []
        for rank, device in enumerate(mesh.devices.flat):
            got = multihost.process_dim0_block(
                Mesh({"data": n, "model": 1}, rank), (rows,))
            want = range(padded)[shards[device][0]]
            assert list(range(rows)[got]) == [i for i in want if i < rows], \
                (rows, rank)
            blocks.append(got)
        union = jax_block(sharding, (padded,))
        assert [i for b in blocks for i in range(rows)[b]] == \
            [i for i in range(padded)[union] if i < rows]


class _Questions:
    """The arrays a Batcher reads, without images."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.questions = rng.integers(0, 9, (n, 4)).astype(np.int32)
        self.question_lengths = np.full(n, 4, np.int32)
        self.answer_indices = rng.integers(1, 5, (n, 2)).astype(np.int32)
        self.answer_values = rng.integers(1, 9, (n, 2)).astype(np.int32)
        self.answer_types = rng.integers(0, 3, n).astype(np.int32)
        self.h5_rows = rng.permutation(n).astype(np.int32)
        self.has_image_rows = True

    def __len__(self):
        return len(self.questions)


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_batches_the_rows_of_jaxs_batcher(n):
    """For the same seed every rank's Batcher (its slice from
    ``process_batch_slice``) yields the rows JAX's ``Batcher`` yields with
    that slice, the padded last batch's mask sliced with them; the ranks'
    rows glued together are the one-process batch."""
    from dl_vqa_tpu.data.pipeline import Batcher as JaxBatcher
    from dl_vqa_tpu_torch.data.pipeline import Batcher

    ds = _Questions(37)  # 3 batches of 16, the last 5 real rows
    whole = list(Batcher(ds, BATCH, shuffle=True, seed=3, load_images=False))
    parts = []
    for rank in range(n):
        rows = multihost.process_batch_slice(
            Mesh({"data": n, "model": 1}, rank), BATCH)
        got = list(Batcher(ds, BATCH, shuffle=True, seed=3,
                           load_images=False, process_slice=rows))
        want = list(JaxBatcher(ds, BATCH, shuffle=True, seed=3,
                               load_images=False, process_slice=rows))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        parts.append(got)
    for i, batch in enumerate(whole):
        for key in batch:
            glued = np.concatenate([p[i][key] for p in parts])
            np.testing.assert_array_equal(glued, batch[key], err_msg=key)
    assert whole[-1]["mask"].sum() == 5
    assert multihost.process_batch_slice(Mesh({"data": 1, "model": 1}),
                                         BATCH) is None
    with pytest.raises(ValueError, match="does not split"):
        multihost.process_batch_slice(Mesh({"data": 3, "model": 1}), BATCH)


# ------------------------------------------------------------ the environment

def test_maybe_initialize_reads_torchrun_environment(monkeypatch):
    """None of torchrun's variables: a no-op that returns False. Part of
    them: raises, naming the missing ones."""
    for name in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.maybe_initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator() and not multihost.active()
    multihost.barrier("alone")  # a no-op in one process
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError,
                       match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT missing"):
        multihost.maybe_initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for("cuda") == "nccl"
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.rank_device("cuda") == torch.device("cuda", 1)
    assert multihost.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("override,error,match", [
    ("tpu.zero_stage=2", SystemExit, "Stage 2 does not exist"),
    ("tpu.zero_stage=4", SystemExit, "must be 0"),
    ("tpu.pipeline_microbatches=2", None, None),
    ("tpu.mesh.stage=2", None, None),
], ids=["tpu.zero_stage=2-SystemExit-Stage 2 does not exist",
        "tpu.zero_stage=4-SystemExit-must be 0",
        "tpu.pipeline_microbatches=2-NotImplementedError-item 9",
        "tpu.mesh.stage=2-NotImplementedError-item 9"])
def test_the_zero_stage_checks(override, error, match):
    """Stages 0, 1 and 3 exist (as in the JAX ``main.py``); the others
    stop the run. The pipeline's settings are taken, as JAX takes them. A
    stage above 0 at one 'data' shard logs its no-op
    (``tests/test_torch_entry.py``)."""
    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch.main import check_supported

    for stage in (0, 1, 3):
        check_supported(config.compose("config",
                                       [f"tpu.zero_stage={stage}"]))
    if error is None:
        check_supported(config.compose("config", [override]))
        return
    with pytest.raises(error, match=match):
        check_supported(config.compose("config", [override]))


# ------------------------------------------------------------ the entry points

def _overrides(profile, logs):
    ov = ["main.use_full=false"]
    for group, paths in profile.items():
        ov += [f"main.small.{group}.{k}={v}" for k, v in paths.items()]
    return ov + [
        f"main.small.paths.logs={logs}/",
        "train.num_epochs=1", f"train.batch_size={BATCH}",
        "train.max_answers=8", "train.image_size=20",
        "train.text.question_features=16",
        "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 8]",
        "train.attention.hidden_dim=16", "train.classifier.hidden_dim=16",
        "tpu.compute_dtype=float32", "tpu.mesh.data=-1"]


def _eval_overrides(profile, logs, ckpt):
    return _overrides(profile, logs) + [
        f"main.small.paths.pretrained_model_path={ckpt}",
        "train.image.stride=1", "train.attention.do_option=+"]


def _run_main(overrides):
    """``main`` on the CPU, with the loss and score of every step."""
    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch import main as main_mod
    from dl_vqa_tpu_torch.train import loop

    steps = {"loss": [], "score": []}
    make = loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, batch, rng):
            state, metrics = step(state, batch, rng)
            for key in steps:
                steps[key].append(float(metrics[key]))
            return state, metrics

        return run

    loop.make_train_step = recording
    try:
        best = main_mod.main(config.compose("config", overrides),
                             device="cpu")
    finally:
        loop.make_train_step = make
    return dict(steps, best=best)


def _worker(root, out_dir):
    """One rank of a torchrun launch (the environment is set): ``main`` at
    ZeRO stages 0, 1, 3, then ``evaluate_vqa``."""
    import torch.distributed as dist

    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2

    torch.set_num_threads(1)
    profile = json.load(open(os.path.join(root, "profile.json")))
    out = {}
    for stage, table in TABLES.items():
        out[f"z{stage}"] = _run_main(
            _overrides(profile, os.path.join(root, f"logs_z{stage}"))
            + table + [f"tpu.zero_stage={stage}"])
    dist.barrier()  # the coordinator's checkpoint is written
    (ckpt,) = glob.glob(os.path.join(root, "logs_z0", "*", "model.ckpt"))
    out["eval"] = evaluate_hw2(
        _eval_overrides(profile, os.path.join(root, "logs_eval"), ckpt)
        + ["tpu.device_image_cache=on",
           "tpu.device_image_cache_layout=sharded"], device="cpu")
    out["rank"], out["world"] = dist.get_rank(), dist.get_world_size()
    out["mesh"] = {"-1": make_mesh(-1, device_type="cpu").shape}
    for data in (1, 4):
        try:
            make_mesh(data, device_type="cpu")
        except ValueError as error:
            out["mesh"][str(data)] = str(error)
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dl_vqa_tpu_torch.data.synthetic import make_synthetic_corpus
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2

    root = str(tmp_path_factory.mktemp("corpus"))
    profile = make_synthetic_corpus(root, n_train=44, n_val=20, n_images=6,
                                    image_size=20, max_answers=8,
                                    learnable=True)
    with open(os.path.join(root, "profile.json"), "w") as f:
        json.dump(profile, f)
    single = _run_main(_overrides(profile, os.path.join(root, "logs_one"))
                       + ["tpu.device_image_cache=on"])
    (ckpt,) = glob.glob(os.path.join(root, "logs_one", "*", "model.ckpt"))
    single["eval"] = evaluate_hw2(
        _eval_overrides(profile, os.path.join(root, "logs_one_eval"), ckpt),
        device="cpu")
    single["eval_z0"] = None

    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "--worker", root, root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, env=env))
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
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(WORLD)]
    # The entry point itself under torchrun (its elastic agent starts the
    # two ranks and sets their environment).
    launched = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "dl_vqa_tpu_torch.main",
         "--device", "cpu", *_overrides(profile, os.path.join(
             root, "logs_torchrun")), "tpu.zero_stage=3"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO
                 + os.pathsep + os.environ.get("PYTHONPATH", "")))
    # The one-process score of the checkpoint the two ranks evaluated.
    (ckpt,) = glob.glob(os.path.join(root, "logs_z0", "*", "model.ckpt"))
    single["eval_z0"] = evaluate_hw2(
        _eval_overrides(profile, os.path.join(root, "logs_one_eval"), ckpt),
        device="cpu")
    return {"root": root, "single": single, "ranks": ranks, "logs": logs,
            "torchrun": launched}


def test_torchrun_launches_the_entry_point(runs):
    """``torchrun --nproc-per-node=2 -m dl_vqa_tpu_torch.main --device cpu
    ... tpu.zero_stage=3``: both ranks print the one-process best score,
    and one experiment dir is written."""
    launched = runs["torchrun"]
    assert launched.returncode == 0, launched.stdout + launched.stderr
    printed = [float(line) for line in launched.stdout.split()
               if line.replace(".", "", 1).isdigit()]
    assert len(printed) == WORLD
    np.testing.assert_allclose(printed, [runs["single"]["best"]] * WORLD,
                               **TOL)
    dirs = glob.glob(os.path.join(runs["root"], "logs_torchrun", "*"))
    assert len([d for d in dirs if os.path.basename(d) != "tensorboard"]) \
        == 1


def test_two_ranks_report_the_same_metrics(runs):
    r0, r1 = runs["ranks"]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, WORLD)
    for key in r0:
        if key != "rank":
            assert r0[key] == r1[key], key


@pytest.mark.parametrize("stage", sorted(TABLES))
def test_main_at_two_ranks_takes_the_one_process_steps(runs, stage):
    """Per-step losses and scores of ``main`` under torchrun (2 gloo
    ranks) at ZeRO stage ``stage``, the last batch padded, against one
    process with the table on: the same, as is the best score."""
    got, want = runs["ranks"][0][f"z{stage}"], runs["single"]
    assert len(got["loss"]) == len(want["loss"]) == 3
    for key in ("loss", "score"):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    np.testing.assert_allclose(got["best"], want["best"], **TOL)


@pytest.mark.parametrize("stage", sorted(TABLES))
def test_only_the_coordinator_writes(runs, stage):
    """One experiment dir, with its log, ``model.ckpt`` and ``last.ckpt``,
    for the two ranks."""
    dirs = glob.glob(os.path.join(runs["root"], f"logs_z{stage}", "*"))
    exp = [d for d in dirs if os.path.basename(d) != "tensorboard"]
    assert len(exp) == 1, dirs
    names = sorted(os.listdir(exp[0]))
    assert "model.ckpt" in names and "last.ckpt" in names
    assert sum(n.endswith(".log") for n in names) == 1


def test_the_padded_batch_splits_unevenly(runs):
    """42 answerable train questions: the last batch's 10 real rows fall
    8 and 2 over the ranks, so a mean of the ranks' means would be another
    loss."""
    from dl_vqa_tpu_torch.data.dataset import VQADataset

    profile = json.load(open(os.path.join(runs["root"], "profile.json")))
    ds = VQADataset.load(VQADataset.cache_path(
        profile["train_paths"]["vqaDataset"]))
    assert len(ds) % BATCH == 10


@pytest.mark.parametrize("data", [-1, 1, 4])
def test_the_mesh_over_two_ranks(runs, data):
    """At two ranks ``data=-1`` takes both; a mesh of 4 raises the JAX
    package's oversubscription message for 4 over 2 devices; a mesh of 1
    raises too (every process is one 'data' shard)."""
    got = runs["ranks"][0]["mesh"][str(data)]
    if data == -1:
        assert got == {"data": WORLD, "model": 1}
    elif data == 1:
        assert "every process is one 'data' shard" in got
    else:
        import jax

        from dl_vqa_tpu.parallel import make_mesh as jax_make_mesh

        with pytest.raises(ValueError) as jax_error:
            jax_make_mesh(data=data, model=1, devices=jax.devices()[:WORLD])
        assert got == str(jax_error.value)


def test_evaluate_vqa_at_two_ranks_gives_the_one_process_score(runs):
    """``evaluate_vqa`` under torchrun with the sharded table scores the
    checkpoint as one process does."""
    assert runs["ranks"][0]["eval"] == runs["single"]["eval_z0"]
    assert 0.0 <= runs["single"]["eval"] <= 100.0


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
