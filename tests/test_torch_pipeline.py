"""The port's 'stage' mesh axis (``dl_vqa_tpu_torch.parallel.pipeline``,
GPipe over the ViT blocks): gloo ranks on the CPU against the JAX
package's executor and pipelined steps on its virtual CPU devices, and
against the port's one process.

One module fixture spawns four ranks (this file run by path as the
worker, joined by gloo, one thread each). They run, each once:

* ``pipeline_apply`` on a stack of 8 ``tanh(x w + b)`` layers over 'stage'
  4 (4 microbatches) and over 'data' 2 x 'stage' 2 (3 microbatches), each
  rank its stage's layers and its rows, with a cotangent for the
  gradients;
* the small ViT of ``tests/test_pipeline.py`` (4 blocks of two heads,
  f32, 2 microbatches of a batch of 8): one train step and an eval step
  at 'data' 2 x 'stage' 2 and at 'model' 2 x 'stage' 2, a train step with
  dropout 0.3, ZeRO 1 and 3 at 'data' 2 x 'stage' 2, a checkpoint written
  there after one step and the one-process checkpoint resumed there;
* ``main`` and ``evaluate_vqa`` of a two-block ViT at 'data' 2 x 'stage'
  2 in 4 microbatches, under torchrun's environment, on a synthetic
  corpus; the microbatch count ``shard_model`` gives the cut ViT.

Tolerances: ``pipeline_apply``'s outputs and gradients at
``tests/test_pipeline.py``'s atol 1e-5, rtol 1e-5 against JAX's; the
steps as that file holds JAX's pipelined step to its sequential one:
losses and scores at rel 1e-5, the parameters after the step at atol 1e-4,
rtol 5e-4 (the microbatches sum the gradients in another order).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import _free_port

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLD = 4
BATCH = 8
MICRO = 2
LR = 1e-3
CORPUS_BATCH = 8
# pipeline_apply's cases: name -> (data, stage, microbatches)
APPLY = {"stage4": (1, 4, 4), "data2_stage2": (2, 2, 3)}
# the steps' meshes: name -> make_mesh keywords
MESHES = {"dp_pp": {"data": 2, "stage": 2},
          "tp_pp": {"data": 1, "model": 2, "stage": 2}}
LAYERS, DIM, MB = 8, 16, 6


# ------------------------------------------------------------ inputs

def _stack(seed=0, micro=4, rows=MB):
    """The layers ``w [L, D, D]``, ``b [L, D]``, the input ``[M, rows,
    D]`` and its cotangent, from the seed."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((LAYERS, DIM, DIM)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((LAYERS, DIM)) * 0.1).astype(np.float32)
    x = rng.standard_normal((micro, rows, DIM)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return w, b, x, cot


def _vit_dict(dropout=0.0, layers=4):
    """``tests/test_pipeline.py::_vit_cfg`` as a config dict."""
    return {"text": {"question_features": 16, "embedding_features": 8,
                     "dropout": dropout},
            "image": {"encoder": "vit", "num_channels": [3, 32],
                      "patch_size": 8, "num_layers": layers,
                      "num_heads": 2, "dropout": dropout},
            "attention": {"hidden_dim": 16, "glimpses": 2,
                          "dropout": dropout},
            "classifier": {"hidden_dim": 16, "dropout": dropout},
            "max_answers": 16, "image_size": 32, "num_tokens": 40}


def _batch(seed=1234):
    """``tests/test_pipeline.py::_vit_batch`` of a batch of 8."""
    rng = np.random.default_rng(seed)
    return {
        "images": rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
        "questions": rng.integers(1, 40, (BATCH, 6)).astype(np.int32),
        "lengths": rng.integers(1, 7, (BATCH,)).astype(np.int32),
        "answer_indices": rng.integers(1, 17, (BATCH, 2)).astype(np.int32),
        "answer_values": rng.integers(0, 11, (BATCH, 2)).astype(np.int32),
        "mask": np.ones((BATCH,), dtype=bool),
    }


# ------------------------------------------------------------ the port

def _state(dropout=0.0, mesh=None, zero=0, restore=None):
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.parallel.tensor import shard_state
    from dl_vqa_tpu_torch.parallel.zero import parallelize
    from dl_vqa_tpu_torch.train import create_train_state
    from dl_vqa_tpu_torch.utils.checkpoint import restore_state

    cfg = ModelConfig.from_meta_dict(_vit_dict(dropout))
    model = VqaNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, device="cpu")
    if restore:
        state, _ = restore_state(state, restore)
    if mesh is not None:
        state = parallelize(shard_state(state, mesh, microbatches=MICRO),
                            mesh, zero)
    return cfg, state


def _rows(batch, mesh):
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice

    rows = None if mesh is None else process_batch_slice(mesh, BATCH)
    return batch if rows is None else {k: v[rows] for k, v in batch.items()}


def _steps(state, cfg, mesh=None, steps=1, dropout_seed=11):
    """``steps`` train steps on ``_batch()`` and an eval step after them;
    their numbers and the state."""
    from dl_vqa_tpu_torch.train import make_eval_step, make_train_step

    batch = _rows(_batch(), mesh)
    step = make_train_step(cfg, torch.float32, mesh=mesh)
    out = {"train": []}
    for _ in range(steps):
        state, metrics = step(state, batch, dropout_seed)
        out["train"].append([float(metrics["loss"]),
                             float(metrics["score"])])
    loss, score = make_eval_step(cfg, torch.float32, mesh=mesh)(
        state.model, batch)
    out["eval"] = [float(loss), float(score)]
    return out, state


def _snapshot(state):
    from dl_vqa_tpu_torch.utils.checkpoint import host_snapshot

    return host_snapshot(state)


# ------------------------------------------------------------ the worker

def _apply(rank):
    """Each case's output and gradients on this rank's stage and rows."""
    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice
    from dl_vqa_tpu_torch.parallel.pipeline import (
        pipeline_apply, stage_layers)

    out = {}
    for name, (data, stage, micro) in APPLY.items():
        mesh = make_mesh(data, stage=stage, device_type="cpu")
        w, b, x, cot = _stack(micro=micro, rows=MB * data)
        mine = stage_layers(LAYERS, stage, mesh.coord("stage"))
        rows = process_batch_slice(mesh, x.shape[1]) or slice(None)
        ws = torch.from_numpy(w[mine]).requires_grad_(True)
        bs = torch.from_numpy(b[mine]).requires_grad_(True)
        local = torch.from_numpy(x[:, rows]).requires_grad_(True)
        got = pipeline_apply(lambda layer, t, m: torch.tanh(t @ layer[0]
                                                            + layer[1]),
                             list(zip(ws, bs)), local, mesh)
        (got * torch.from_numpy(cot[:, rows])).sum().backward()
        out[name] = {"rows": [rows.start or 0, rows.stop or x.shape[1]],
                     "layers": [mine.start, mine.stop],
                     "out": got.detach().numpy().tolist(),
                     "dx": local.grad.numpy().tolist(),
                     "dw": ws.grad.numpy().tolist(),
                     "db": bs.grad.numpy().tolist()}
    return out


def _microbatches():
    """The microbatch count the ViT of a model cut by ``shard_model`` runs
    with, by case: 'stage' 2 with ``microbatches`` 0 and 4, and 'data' 4
    (no 'stage') with 4; None where it holds no pipeline context."""
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.parallel.tensor import shard_model

    out = {}
    for name, data, stage, micro in (("stage2_0", 2, 2, 0),
                                     ("stage2_4", 2, 2, 4),
                                     ("stage1_4", 4, 1, 4)):
        model = VqaNet(ModelConfig.from_meta_dict(_vit_dict()), device="cpu",
                       generator=torch.Generator().manual_seed(0))
        shard_model(model, make_mesh(data, stage=stage, device_type="cpu"),
                    microbatches=micro)
        ctx = model.image.pipeline
        out[name] = None if ctx is None else ctx.num_microbatches
    return out


def _corpus_overrides(root, logs):
    profile = json.load(open(os.path.join(root, "profile.json")))
    ov = ["main.use_full=false"]
    for group, paths in profile.items():
        ov += [f"main.small.{group}.{k}={v}" for k, v in paths.items()]
    return ov + [
        f"main.small.paths.logs={logs}/", "train.num_epochs=1",
        f"train.batch_size={CORPUS_BATCH}", "train.max_answers=8",
        "train.image_size=32", "train.text.question_features=16",
        "train.text.embedding_features=8", "train.image.encoder=vit",
        "train.image.num_channels=[3, 64]", "train.image.patch_size=8",
        "train.image.num_layers=2", "train.image.num_heads=1",
        "train.attention.hidden_dim=16", "train.classifier.hidden_dim=16",
        "tpu.compute_dtype=float32"]


def _entry_points(root, mesh_overrides, tag):
    """``main`` for an epoch and ``evaluate_vqa`` of its checkpoint."""
    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2
    from dl_vqa_tpu_torch.main import main

    ov = _corpus_overrides(root, os.path.join(root, f"logs_{tag}"))
    best = main(config.compose("config", ov + mesh_overrides), device="cpu")
    if torch.distributed.is_initialized():
        torch.distributed.barrier()  # the coordinator's checkpoint
    (ckpt,) = glob.glob(os.path.join(root, f"logs_{tag}", "*",
                                     "model.ckpt"))
    score = evaluate_hw2(
        _corpus_overrides(root, os.path.join(root, f"logs_{tag}_eval"))
        + mesh_overrides + [f"main.small.paths.pretrained_model_path={ckpt}",
                            "train.image.stride=1",
                            "train.attention.do_option=+"], device="cpu")
    return {"best": best, "eval": score}


def _worker(rank, port, out_dir, root):
    import torch.distributed as dist

    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    numbers = {"rank": rank, "apply": _apply(rank),
               "micro": _microbatches()}
    arrays = {}
    for name, kw in MESHES.items():
        kw = dict(kw)
        mesh = make_mesh(kw.pop("data"), device_type="cpu", **kw)
        cfg, state = _state(mesh=mesh)
        numbers[name], state = _steps(state, cfg, mesh)
        numbers[name + "/blocks"] = len(state.model.image.blocks)
        numbers[name + "/qkv"] = list(
            state.model.image.blocks[0].qkv.weight.shape)
        arrays.update({f"{name}/{k}": v
                       for k, v in _snapshot(state).items()})
    mesh = make_mesh(2, stage=2, device_type="cpu")
    cfg, state = _state(0.3, mesh)
    numbers["dropout"], state = _steps(state, cfg, mesh)
    arrays.update({f"dropout/{k}": v for k, v in _snapshot(state).items()})
    for zero in (1, 3):
        cfg, state = _state(mesh=mesh, zero=zero)
        numbers[f"zero{zero}"], state = _steps(state, cfg, mesh)
        arrays.update({f"zero{zero}/{k}": v
                       for k, v in _snapshot(state).items()})
    # A checkpoint after one step at 'stage' 2 (every rank gathers, the
    # coordinator writes); the one-process one resumed here.
    cfg, state = _state(mesh=mesh)
    _, state = _steps(state, cfg, mesh)
    if rank == 0:
        save_checkpoint(os.path.join(out_dir, "stage_step1.ckpt"), state,
                        epoch=0)
    else:
        _snapshot(state)  # the coordinator's gather
    dist.barrier()
    cfg, state = _state(mesh=mesh,
                        restore=os.path.join(out_dir, "single_step1.ckpt"))
    numbers["resumed"], state = _steps(state, cfg, mesh)
    numbers["entry"] = _entry_points(
        root, ["tpu.mesh.stage=2", "tpu.pipeline_microbatches=4"], "stage")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(numbers, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------ the fixture

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references (a checkpoint of the first step written
    before the ranks start), then the four ranks' results."""
    from dl_vqa_tpu.data import synthetic
    from dl_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    root = str(tmp_path_factory.mktemp("corpus"))
    profile = synthetic.make_synthetic_corpus(
        root, n_train=24, n_val=16, n_images=6, image_size=32,
        max_answers=8, learnable=True)
    with open(os.path.join(root, "profile.json"), "w") as f:
        json.dump(profile, f)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {}
        cfg, state = _state()
        single["step1"], state = _steps(state, cfg)
        save_checkpoint(os.path.join(out_dir, "single_step1.ckpt"), state,
                        epoch=0)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, HERE, "--worker", str(rank), str(port), out_dir,
             root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO, env=env) for rank in range(WORLD)]
        try:
            single["step2"], state = _steps(state, cfg)
            single["step2/params"] = _snapshot(state)
            cfg, state = _state(0.3)
            single["dropout"], state = _steps(state, cfg)
            single["dropout/params"] = _snapshot(state)
            single["entry"] = _entry_points(root, [], "single")
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    finally:
        torch.set_num_threads(threads)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(WORLD)]
    with np.load(os.path.join(out_dir, "arrays.npz")) as data:
        arrays = {key: data[key] for key in data.files}
    return {"ranks": ranks, "arrays": arrays, "single": single,
            "dir": out_dir}


def _arrays(runs, name):
    prefix = name + "/"
    return {k[len(prefix):]: v for k, v in runs["arrays"].items()
            if k.startswith(prefix)}


def _params_close(got, want, what):
    """The parameters of two flat snapshots at atol 1e-4, rtol 5e-4, as
    ``tests/test_pipeline.py`` holds JAX's pipelined step."""
    names = [k for k in want if k.startswith("params|")]
    assert names and all(k in got for k in names), what
    for key in names:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   rtol=5e-4, err_msg=f"{what}: {key}")


# ------------------------------------------------------------ against JAX

def _jax_apply(name, grad):
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.parallel.pipeline import (
        make_pipeline_mesh, pipeline_apply)

    data, stage, micro = APPLY[name]
    w, b, x, cot = (jnp.asarray(a) for a in _stack(micro=micro,
                                                   rows=MB * data))
    mesh = make_pipeline_mesh(data=data, stage=stage)

    def fn(layer, t):
        return jnp.tanh(t @ layer["w"] + layer["b"])

    def loss(layers, x_):
        return jnp.sum(pipeline_apply(fn, layers, x_, mesh) * cot)

    layers = {"w": w, "b": b}
    if not grad:
        return {"out": np.asarray(pipeline_apply(fn, layers, x, mesh))}
    g_layers, g_x = jax.grad(loss, argnums=(0, 1))(layers, x)
    return {"dx": np.asarray(g_x), "dw": np.asarray(g_layers["w"]),
            "db": np.asarray(g_layers["b"])}


@pytest.mark.parametrize("part", ["out", "grad"])
@pytest.mark.parametrize("name", list(APPLY))
def test_pipeline_apply_is_jaxs(runs, name, part):
    """Each rank's outputs and gradients, put in their places (its rows,
    its stage's layers), against JAX's ``pipeline_apply`` on the same
    mesh of virtual devices and its ``jax.grad``; every rank of a stage
    group holds the whole stack's outputs."""
    want = _jax_apply(name, part == "grad")
    got = {key: np.zeros(value.shape, np.float32)
           for key, value in want.items()}
    for rank in runs["ranks"]:
        mine = rank["apply"][name]
        rows, layers = slice(*mine["rows"]), slice(*mine["layers"])
        if part == "out":
            got["out"][:, rows] = mine["out"]
        elif layers.start == 0:  # the input feeds stage 0 alone
            got["dx"][:, rows] = mine["dx"]
        if part == "grad":
            # A stage's layers take the gradient of each 'data' rank's
            # rows.
            got["dw"][layers] += np.asarray(mine["dw"], np.float32)
            got["db"][layers] += np.asarray(mine["db"], np.float32)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{name}: {key}")


def _jax_step(mesh_kw, dropout=0.0):
    """JAX's pipelined train step (2 microbatches) from the port's initial
    parameters on ``_batch()``, and its pipelined eval step after it."""
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.models import ModelConfig
    from dl_vqa_tpu.parallel import make_mesh
    from dl_vqa_tpu.parallel.pipeline import PipelineContext
    from dl_vqa_tpu.train.state import create_train_state
    from dl_vqa_tpu.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from dl_vqa_tpu.utils.checkpoint import _flatten as jax_flatten
    from dl_vqa_tpu_torch.utils.params import jax_params_from_model

    _, state = _state()
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_params_from_model(state.model))
    cfg = ModelConfig.from_meta_dict(_vit_dict(dropout))
    ctx = PipelineContext(make_mesh(**mesh_kw), num_microbatches=MICRO)
    tx = make_optimizer(LR)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    new, metrics = make_train_step(cfg, tx, compute_dtype=jnp.float32,
                                   pipeline_ctx=ctx)(
        create_train_state(params, tx), batch, jax.random.PRNGKey(3))
    loss, score = make_eval_step(cfg, compute_dtype=jnp.float32,
                                 pipeline_ctx=ctx)(new.params, batch)
    return ({"train": [[float(metrics["loss"]), float(metrics["score"])]],
             "eval": [float(loss), float(score)]},
            jax_flatten(jax.device_get(new)))


@pytest.mark.parametrize("name", list(MESHES))
def test_the_pipelined_steps_are_jaxs(runs, name):
    """One train step and an eval step after it at 'data' 2 x 'stage' 2
    and at 'model' 2 x 'stage' 2, against JAX's pipelined steps on the
    same mesh: losses and scores at rel 1e-5 on every rank, the gathered
    parameters at atol 1e-4, rtol 5e-4."""
    expected, params = _jax_step(MESHES[name])
    for rank in runs["ranks"]:
        for key in ("train", "eval"):
            np.testing.assert_allclose(rank[name][key], expected[key],
                                       rtol=1e-5, err_msg=key)
    _params_close(_arrays(runs, name), params, name)


def test_each_stage_rank_holds_its_blocks(runs):
    """At 'stage' 2 a rank keeps two of the four blocks; at 'model' 2 x
    'stage' 2 they hold one of two heads' q, k and v columns too."""
    for rank in runs["ranks"]:
        assert rank["dp_pp/blocks"] == rank["tp_pp/blocks"] == 2
        assert rank["dp_pp/qkv"] == [96, 32]
        assert rank["tp_pp/qkv"] == [48, 32]


# ------------------------------------------------------------ the port

def test_the_ranks_drop_what_one_process_drops(runs):
    """Dropout 0.3 at 'data' 2 x 'stage' 2: every block's masks are drawn
    for the whole batch in one process's order and each microbatch keeps
    its rows, so the step is the port's one-process step: losses and
    scores at rel 1e-5, the parameters as above."""
    want = runs["single"]["dropout"]
    for rank in runs["ranks"]:
        for key in ("train", "eval"):
            np.testing.assert_allclose(rank["dropout"][key], want[key],
                                       rtol=1e-5, err_msg=key)
    _params_close(_arrays(runs, "dropout"),
                  runs["single"]["dropout/params"], "dropout")


@pytest.mark.parametrize("zero", [1, 3])
def test_zero_1_and_3_compose_with_stage(runs, zero):
    """ZeRO 1 and 3 over the 'data' group of a stage-cut model give ZeRO
    0's numbers and parameters to the bit."""
    ranks = runs["ranks"]
    assert all(r[f"zero{zero}"] == ranks[0]["dp_pp"] for r in ranks)
    base = _arrays(runs, "dp_pp")
    got = _arrays(runs, f"zero{zero}")
    assert got.keys() == base.keys()
    for key, value in base.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_a_stage_checkpoint_resumes_in_one_process_and_back(runs):
    """The checkpoint two stages write after a step is the one-process
    npz: resumed in one process, its second step is the unbroken run's;
    and the one-process checkpoint resumed at 'data' 2 x 'stage' 2 takes
    that step too."""
    from dl_vqa_tpu_torch.utils.checkpoint import load_checkpoint

    flat, meta = load_checkpoint(os.path.join(runs["dir"],
                                              "stage_step1.ckpt"))
    assert meta["epoch"] == 0 and int(flat["step"]) == 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the references
    try:
        cfg, state = _state(restore=os.path.join(runs["dir"],
                                                 "stage_step1.ckpt"))
        resumed, state = _steps(state, cfg)
    finally:
        torch.set_num_threads(threads)
    want = runs["single"]["step2"]
    np.testing.assert_allclose(resumed["train"], want["train"], rtol=1e-5)
    _params_close(_snapshot(state), runs["single"]["step2/params"],
                  "resumed in one process")
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["resumed"]["train"], want["train"],
                                   rtol=1e-5)


def test_main_and_evaluate_vqa_run_under_stage(runs):
    """``main`` and ``evaluate_vqa`` of a two-block ViT at 'data' 2 x
    'stage' 2 under torchrun's environment: every rank reports the same
    best score and evaluation, and both agree with one process."""
    entries = [rank["entry"] for rank in runs["ranks"]]
    assert all(e == entries[0] for e in entries)
    np.testing.assert_allclose(
        [entries[0]["best"], entries[0]["eval"]],
        [runs["single"]["entry"]["best"], runs["single"]["entry"]["eval"]],
        atol=0.02)


# ------------------------------------------------------------ refusals

def _jax_error(case):
    """The JAX package's error for ``case``."""
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.models import ModelConfig, vqa
    from dl_vqa_tpu.parallel import make_mesh
    from dl_vqa_tpu.parallel.pipeline import (
        PipelineContext, make_pipeline_mesh, pipeline_apply, stack_layers)

    if case in ("layers", "no_micro"):
        mesh = make_pipeline_mesh(data=1, stage=3 if case == "layers" else 2)
        layers = stack_layers([{"w": jnp.zeros((4, 4))}] * 6)
        x = jnp.zeros((0 if case == "no_micro" else 2, 2, 4))
        with pytest.raises(ValueError) as error:
            pipeline_apply(lambda layer, t: t, layers if case == "no_micro"
                           else stack_layers([{"w": jnp.zeros((4, 4))}] * 4),
                           x, mesh)
        return error
    d = _vit_dict()
    mesh_kw, micro, batch = {"data": 2, "model": 1, "stage": 2}, 2, 4
    if case == "batch":
        micro = 3
    elif case == "micro_rows":
        mesh_kw, batch = {"data": 4, "model": 1, "stage": 2}, 4
    elif case == "cnn":
        d["image"] = {"num_channels": [3, 4, 8], "dropout": 0.0}
    elif case == "moe":
        d["image"]["moe_experts"] = 4
    cfg = ModelConfig.from_meta_dict(d)
    params = vqa.init(jax.random.PRNGKey(0), cfg)
    if case == "int8":
        import dataclasses

        cfg = dataclasses.replace(cfg, image=dataclasses.replace(
            cfg.image, store_dtype="int8",
            quant_scales=(1.0,) * (4 * cfg.image.num_layers)))
    b = {k: v[:batch] for k, v in _batch().items()}
    ctx = PipelineContext(make_mesh(**mesh_kw), num_microbatches=micro)
    with pytest.raises((ValueError, NotImplementedError)) as error:
        vqa.apply(params, cfg, b["images"], b["questions"], b["lengths"],
                  compute_dtype=jnp.float32, pipeline_ctx=ctx)
    return error


@pytest.mark.parametrize("case", ["layers", "no_micro", "batch",
                                  "micro_rows", "cnn", "int8", "moe"])
def test_the_refusals_are_jaxs(case):
    """What the JAX package refuses under 'stage' the port refuses with
    its words: a layer count the axis does not divide, no microbatch, a
    batch the count does not divide, a microbatch the 'data' axis does not
    divide, the CNN, the int8 ViT and a ViT-MoE."""
    import dataclasses

    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.parallel.mesh import Mesh
    from dl_vqa_tpu_torch.parallel.pipeline import (
        PipelineContext, check_pipeline, microbatch_rows, pipeline_apply,
        stage_layers)

    jax_error = _jax_error(case)
    with pytest.raises(type(jax_error.value)) as port_error:
        if case == "layers":
            stage_layers(4, 3, 0)
        elif case == "no_micro":
            pipeline_apply(lambda layer, t, m: t, [], torch.zeros(0, 2, 4),
                           None)
        elif case == "batch":
            microbatch_rows(2, PipelineContext(
                Mesh({"data": 2, "model": 1, "stage": 2}), 3))
        elif case == "micro_rows":
            microbatch_rows(1, PipelineContext(
                Mesh({"data": 4, "model": 1, "stage": 2}), 2))
        else:
            d = _vit_dict()
            if case == "cnn":
                d["image"] = {"num_channels": [3, 4, 8], "dropout": 0.0}
            elif case == "moe":
                d["image"]["moe_experts"] = 4
            cfg = ModelConfig.from_meta_dict(d)
            if case == "int8":
                cfg = dataclasses.replace(cfg, image=dataclasses.replace(
                    cfg.image, store_dtype="int8",
                    quant_scales=(1.0,) * 16))
            check_pipeline(cfg, 2)
    assert str(port_error.value) == str(jax_error.value)


def test_the_pipeline_microbatches_are_taken_as_jax_takes_them(runs):
    """``tpu.pipeline_microbatches`` 0 means one a stage; at 'stage' 1
    there is no context, and the setting is ignored, as in JAX (the
    entry points pass it to ``shard_model``, which gives the cut ViT its
    context)."""
    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch.main import check_supported

    check_supported(config.compose("config_vit",
                                   ["tpu.pipeline_microbatches=4"]))
    for rank in runs["ranks"]:
        assert rank["micro"] == {"stage2_0": 2, "stage2_4": 4,
                                 "stage1_4": None}


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
