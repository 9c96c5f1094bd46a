"""The port's 'seq' mesh axis (``dl_vqa_tpu_torch.parallel.sequence``, the
ring of ``dl_vqa_tpu_torch.ops.ring_attention``): gloo ranks on the CPU
against the JAX package's ring and seq-parallel steps on its virtual CPU
devices, and the refusals.

One module fixture spawns four ranks (this file run by path as the
worker, joined by gloo, one thread each). They run, each once:

* the ring on a packed qkv ``[4, 16, 3 * 24]`` of two heads, over a 'seq'
  axis of 4 (one group) and of 2 ('data' 2 x 'seq' 2), each rank on its
  tokens (and rows), with a cotangent for the gradients;
* the small ViT of ``tests/test_ring_attention.py`` (16 tokens, two
  blocks of two heads, f32): its eval step at 'seq' 2 x 'model' 2, and one
  train step at 'data' 2 x 'seq' 2, also at dropout 0.3 against the
  port's one process;
* ``main`` and ``evaluate_vqa`` of a one-block ViT at 'data' 2 x 'seq' 2,
  under torchrun's environment, on a synthetic corpus;
* the ViT-MoE (the same ViT, 4 experts, top-2): the gating on each rank's
  tokens of router logits whose capacity drops slots, and one train step
  at 'data' 2 x 'seq' 2 and at 'seq' 2 x 'expert' 2; the int8 ViT's eval
  step at 'data' 2 x 'seq' 2, calibrated on the whole model.

Tolerances: the ring's outputs and gradients at ``test_ring_attention.py``'s
atol 1e-5, rtol 1e-5 against JAX's ring; the steps at its tolerances
against JAX's seq-parallel steps: the losses and scores at rel 1e-5, the
parameters after the step at atol 5e-5, rtol 5e-4. The MoE routes are
one process's to the bit (the same kept slots at the same places), and
the int8 ViT's image features one process's bits.
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
HEADS = 2
CORPUS_BATCH = 8
MOE_MESHES = {"moe_dp_sp": {"data": 2, "seq": 2},
              "moe_sp_ep": {"data": 1, "seq": 2, "expert": 2}}


def _qkv(batch=4, seq=16, dim=24, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((batch, seq, 3 * dim)).astype(np.float32)
    cot = rng.standard_normal((batch, seq, dim)).astype(np.float32)
    return qkv, cot


def _vit_dict(image_size=32, layers=2, dropout=0.0, moe=0):
    """``tests/test_ring_attention.py::_vit_cfg`` as a config dict; ``moe``
    experts, top-2, make its blocks MoE blocks."""
    return {"text": {"question_features": 16, "embedding_features": 8,
                     "dropout": dropout},
            "image": {"encoder": "vit", "num_channels": [3, 16],
                      "patch_size": 8, "num_layers": layers,
                      "num_heads": 2, "dropout": dropout,
                      "moe_experts": moe},
            "attention": {"hidden_dim": 16, "glimpses": 2,
                          "dropout": dropout},
            "classifier": {"hidden_dim": 16, "dropout": dropout},
            "max_answers": 16, "image_size": image_size, "num_tokens": 32}


def _batch(batch=16, seed=0, image_size=32):
    """``tests/test_ring_attention.py::_batch``."""
    rng = np.random.default_rng(seed)
    return {
        "images": rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32),
        "questions": rng.integers(0, 32, (batch, 6)).astype(np.int32),
        "lengths": rng.integers(1, 7, (batch,)).astype(np.int32),
        "answer_indices": rng.integers(1, 17, (batch, 2)).astype(np.int32),
        "answer_values": rng.integers(1, 10, (batch, 2)).astype(np.int32),
        "mask": np.ones((batch,), dtype=bool),
    }


def _jax_params(moe=0):
    import jax

    from dl_vqa_tpu.models import ModelConfig, vqa

    cfg = ModelConfig.from_meta_dict(_vit_dict(moe=moe))
    return jax.tree_util.tree_map(np.asarray,
                                  vqa.init(jax.random.PRNGKey(0), cfg))


def _port_model(params, dropout=0.0, moe=0):
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.utils.params import load_jax_params

    cfg = ModelConfig.from_meta_dict(_vit_dict(dropout=dropout, moe=moe))
    return cfg, load_jax_params(VqaNet(cfg, device="cpu"), params)


def _port_train(params, mesh=None, dropout=0.0, moe=0):
    """One port train step on ``_batch(seed=6)`` (this rank's rows over
    ``mesh``): its loss and score (and balance loss, with ``moe``
    experts), and the parameters after it in the JAX layout, flat."""
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice
    from dl_vqa_tpu_torch.parallel.tensor import shard_state
    from dl_vqa_tpu_torch.parallel.zero import parallelize
    from dl_vqa_tpu_torch.train import create_train_state, make_train_step
    from dl_vqa_tpu_torch.utils.params import jax_params_from_model

    cfg, model = _port_model(params, dropout, moe)
    state = create_train_state(model, 1e-3, device="cpu")
    batch = _batch(seed=6)
    if mesh is not None:
        state = parallelize(shard_state(state, mesh), mesh, 0)
        rows = process_batch_slice(mesh, 16)
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
    state, metrics = make_train_step(cfg, torch.float32, mesh=mesh)(
        state, batch, 11)
    numbers = [float(metrics["loss"]), float(metrics["score"])]
    if moe:
        numbers.append(float(metrics["moe_aux"]))
    if mesh is not None and mesh.splits_state:
        from dl_vqa_tpu_torch.parallel.zero import full_state
        from dl_vqa_tpu_torch.utils.params import jax_tree_from_named

        return numbers, _flatten(jax_tree_from_named(full_state(state)[0]))
    return numbers, _flatten(jax_params_from_model(state.model))


def _port_int8(params, mesh=None):
    """The int8 ViT's eval step on ``_batch(seed=5)`` (this rank's rows
    over ``mesh``), calibrated on the whole model before it is cut, and
    its image features; and the scales."""
    from dl_vqa_tpu_torch.models.layers import normalize_images
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice
    from dl_vqa_tpu_torch.parallel.tensor import shard_model
    from dl_vqa_tpu_torch.train import make_eval_step

    cfg, model = _port_model(params)
    batch = _batch(seed=5)
    cfg = model.int8_calibrated(batch["images"], dtype=torch.float32)
    model.configure(cfg)
    if mesh is not None:
        shard_model(model, mesh)
        rows = process_batch_slice(mesh, 16)
        batch = {k: v[rows] for k, v in batch.items()}
    loss, score = make_eval_step(cfg, torch.float32, mesh=mesh)(model,
                                                                batch)
    with torch.no_grad():
        features = model.image(normalize_images(
            torch.from_numpy(batch["images"]), torch.float32),
            torch.float32, False, None)
    return ([float(loss), float(score)], features.numpy().tolist(),
            list(cfg.image.quant_scales))


def _logits(seed=3):
    """Router logits ``[3, 16, 4]`` whose capacity of 5 drops slots."""
    return np.random.default_rng(seed).standard_normal(
        (3, 16, 4)).astype(np.float32) * 2.0


def _routes(mesh):
    """This rank's gating of its tokens of :func:`_logits`, top-2 at
    capacity 5 (the whole sequence's)."""
    from dl_vqa_tpu_torch.ops.moe import top_k_gating
    from dl_vqa_tpu_torch.parallel.sequence import SequenceContext

    seq = SequenceContext.of(mesh)
    tokens = seq.tokens(16)
    routing = top_k_gating(torch.from_numpy(_logits()[:, tokens]), 2, 5,
                           seq)
    return {"tokens": [tokens.start, tokens.stop],
            **{key: getattr(routing, key).tolist()
               for key in ("expert", "position", "kept", "weight")}}


# ------------------------------------------------------------ the worker

def _ring(mesh, rank):
    """This rank's output and qkv gradient of the ring on its rows and
    tokens, with where they lie."""
    from dl_vqa_tpu_torch.ops.ring_attention import ring_attention_qkv
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice
    from dl_vqa_tpu_torch.parallel.sequence import SequenceContext

    seq = SequenceContext.of(mesh)
    qkv, cot = _qkv()
    rows = process_batch_slice(mesh, qkv.shape[0]) or slice(None)
    tokens = seq.tokens(qkv.shape[1])
    local = torch.from_numpy(qkv[rows, tokens]).requires_grad_(True)
    out = ring_attention_qkv(local, HEADS, seq)
    (out * torch.from_numpy(cot[rows, tokens])).sum().backward()
    return {"rows": [rows.start or 0, rows.stop or qkv.shape[0]],
            "tokens": [tokens.start, tokens.stop],
            "out": out.detach().numpy().tolist(),
            "grad": local.grad.numpy().tolist()}


def _steps(params, rank):
    """The eval step at 'seq' 2 x 'model' 2 and one train step at 'data' 2
    x 'seq' 2, from the JAX parameters, without and with dropout."""
    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.parallel.tensor import shard_state
    from dl_vqa_tpu_torch.train import create_train_state, make_eval_step

    out = {}
    mesh = make_mesh(1, model=2, seq=2, device_type="cpu")
    cfg, model = _port_model(params)
    state = shard_state(create_train_state(model, 1e-3, device="cpu"), mesh)
    loss, score = make_eval_step(cfg, torch.float32, mesh=mesh)(
        state.model, _batch(seed=5))
    out["eval"] = [float(loss), float(score)]

    mesh = make_mesh(2, seq=2, device_type="cpu")
    out["train"], flat = _port_train(params, mesh)
    out["train_dropout"], dropped = _port_train(params, mesh, dropout=0.3)
    out["routes"] = _routes(mesh)
    out["int8"] = _port_int8(params, mesh)
    if rank == 0:
        out["params"] = flat
        out["params_dropout"] = dropped
    return out


def _moe_steps(moe_params, rank):
    """One ViT-MoE train step at 'data' 2 x 'seq' 2 and at 'seq' 2 x
    'expert' 2."""
    from dl_vqa_tpu_torch.parallel import make_mesh

    out, arrays = {}, {}
    for name, kw in MOE_MESHES.items():
        kw = dict(kw)
        mesh = make_mesh(kw.pop("data"), device_type="cpu", **kw)
        out[name], flat = _port_train(moe_params, mesh, moe=4)
        if rank == 0:
            arrays.update({f"{name}{k}": v for k, v in flat.items()})
    return out, arrays


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
        "train.image.num_layers=1", "train.image.num_heads=1",
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

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    numbers = {"rank": rank,
               "ring4": _ring(make_mesh(1, seq=4, device_type="cpu"), rank),
               "ring2": _ring(make_mesh(2, seq=2, device_type="cpu"), rank)}
    with np.load(os.path.join(out_dir, "params.npz")) as data:
        params = _unflatten({k: data[k] for k in data.files})
    steps = _steps(params, rank)
    flat = steps.pop("params", None)
    dropped = steps.pop("params_dropout", None)
    numbers.update(steps)
    with np.load(os.path.join(out_dir, "params_moe.npz")) as data:
        moe_params = _unflatten({k: data[k] for k in data.files})
    moe, moe_arrays = _moe_steps(moe_params, rank)
    numbers.update(moe)
    numbers["entry"] = _entry_points(root, ["tpu.mesh.seq=2"], "seq")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(numbers, f)
    if flat is not None:
        np.savez(os.path.join(out_dir, "train_params.npz"), **flat)
        np.savez(os.path.join(out_dir, "dropout_params.npz"), **dropped)
        np.savez(os.path.join(out_dir, "moe_params.npz"), **moe_arrays)
    dist.barrier()
    dist.destroy_process_group()


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _unflatten(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        keys = path.strip("/").split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree


# ------------------------------------------------------------ the fixture

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, and the one-process entry points."""
    from dl_vqa_tpu.data import synthetic

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    root = str(tmp_path_factory.mktemp("corpus"))
    profile = synthetic.make_synthetic_corpus(
        root, n_train=24, n_val=16, n_images=6, image_size=32,
        max_answers=8, learnable=True)
    with open(os.path.join(root, "profile.json"), "w") as f:
        json.dump(profile, f)
    params = _jax_params()
    np.savez(os.path.join(out_dir, "params.npz"), **_flatten(params))
    moe_params = _jax_params(moe=4)
    np.savez(os.path.join(out_dir, "params_moe.npz"),
             **_flatten(moe_params))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, HERE, "--worker", str(rank), str(port), out_dir,
         root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for rank in range(WORLD)]
    try:
        single = _entry_points(root, [], "single")
        single["dropout"] = _port_train(params, dropout=0.3)
        single["moe"] = _port_train(moe_params, moe=4)
        single["int8"] = _port_int8(params)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(WORLD)]
    trained = {}
    for name in ("train", "dropout", "moe"):
        with np.load(os.path.join(out_dir, f"{name}_params.npz")) as data:
            trained[name] = {k: data[k] for k in data.files}
    return {"ranks": ranks, "params": params, "trained": trained,
            "single": single, "moe_params": moe_params}


# ------------------------------------------------------------ the tests

def _jax_ring(n_seq, grad):
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.ops.ring_attention import ring_attention_qkv
    from dl_vqa_tpu.parallel import make_mesh

    qkv, cot = (jnp.asarray(a) for a in _qkv())
    mesh = make_mesh(data=2, model=1, seq=n_seq)
    if not grad:
        return np.asarray(ring_attention_qkv(qkv, HEADS, mesh))
    return np.asarray(jax.grad(lambda x: jnp.sum(
        ring_attention_qkv(x, HEADS, mesh) * cot))(qkv))


@pytest.mark.parametrize("part", ["out", "grad"])
@pytest.mark.parametrize("n_seq", [2, 4])
def test_the_ring_is_jaxs_ring(runs, n_seq, part):
    """Each rank's output and qkv gradient, put in their places, against
    JAX's ``ring_attention_qkv`` on ``2 n`` virtual devices and its
    ``jax.grad``."""
    qkv, _ = _qkv()
    width = qkv.shape[-1] // 3 if part == "out" else qkv.shape[-1]
    got = np.full(qkv.shape[:2] + (width,), np.nan, np.float32)
    for rank in runs["ranks"]:
        mine = rank[f"ring{n_seq}"]
        got[slice(*mine["rows"]), slice(*mine["tokens"])] = mine[part]
    np.testing.assert_allclose(got, _jax_ring(n_seq, part == "grad"),
                               atol=1e-5, rtol=1e-5)


def _jax_steps(params, which):
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.models import ModelConfig
    from dl_vqa_tpu.parallel import SequenceContext, batch_sharding, make_mesh
    from dl_vqa_tpu.train.state import create_train_state
    from dl_vqa_tpu.train.steps import (
        make_eval_step, make_optimizer, make_train_step)

    cfg = ModelConfig.from_meta_dict(_vit_dict())
    if which == "eval":
        mesh = make_mesh(data=1, model=2, seq=2)
        step = make_eval_step(cfg, compute_dtype=jnp.float32,
                              seq_ctx=SequenceContext(mesh))
        batch = {k: jax.device_put(v, batch_sharding(mesh))
                 for k, v in _batch(seed=5).items()}
        loss, score = step(params, batch)
        return [float(loss), float(score)], None
    tx = make_optimizer(1e-3)
    mesh = make_mesh(data=2, model=1, seq=2)
    step = make_train_step(cfg, tx, compute_dtype=jnp.float32,
                           seq_ctx=SequenceContext(mesh))
    batch = {k: jax.device_put(v, batch_sharding(mesh))
             for k, v in _batch(seed=6).items()}
    state, metrics = step(create_train_state(params, tx), batch,
                          jax.random.PRNGKey(11))
    return ([float(metrics["loss"]), float(metrics["score"])],
            _flatten(jax.tree_util.tree_map(np.asarray, state.params)))


def test_the_eval_step_at_seq_2_model_2_is_jaxs(runs):
    """The eval step's loss and score at 'seq' 2 x 'model' 2 (each model
    rank's head riding the ring) against JAX's seq-parallel eval step, on
    every rank."""
    expected, _ = _jax_steps(runs["params"], "eval")
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["eval"], expected, rtol=1e-5)


def test_the_train_step_at_data_2_seq_2_is_jaxs(runs):
    """One train step at 'data' 2 x 'seq' 2: its loss and score on every
    rank, and the parameters after it (the ViT's gradients summed over
    'seq'), against JAX's seq-parallel train step."""
    expected, params = _jax_steps(runs["params"], "train")
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["train"], expected, rtol=1e-5)
    got = runs["trained"]["train"]
    assert got.keys() == params.keys()
    for key, value in params.items():
        np.testing.assert_allclose(got[key], value, atol=5e-5, rtol=5e-4,
                                   err_msg=key)


def test_the_ranks_drop_what_one_process_drops(runs):
    """Dropout 0.3 at 'data' 2 x 'seq' 2: each rank draws the whole batch's
    and sequence's masks and keeps its rows and tokens, so the step is the
    port's one-process step (the JAX masks come from another generator):
    loss and score at rel 1e-5, the parameters at atol 5e-5, rtol 5e-4."""
    expected, params = runs["single"]["dropout"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["train_dropout"], expected,
                                   rtol=1e-5)
    got = runs["trained"]["dropout"]
    assert got.keys() == params.keys()
    for key, value in params.items():
        np.testing.assert_allclose(got[key], value, atol=5e-5, rtol=5e-4,
                                   err_msg=key)


def test_main_and_evaluate_vqa_run_under_seq(runs):
    """``main`` and ``evaluate_vqa`` of a one-block ViT at 'data' 2 x
    'seq' 2 under torchrun's environment: every rank reports the same
    best score and evaluation, and both agree with one process."""
    entries = [rank["entry"] for rank in runs["ranks"]]
    assert all(e == entries[0] for e in entries)
    np.testing.assert_allclose(
        [entries[0]["best"], entries[0]["eval"]],
        [runs["single"]["best"], runs["single"]["eval"]], atol=0.02)


# ------------------------------------------------------------ refusals

def _jax_apply_error(cfg_dict, mesh_kw, pipeline=False):
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.models import ModelConfig, vqa
    from dl_vqa_tpu.parallel import SequenceContext, make_mesh

    cfg = ModelConfig.from_meta_dict(cfg_dict)
    mesh = make_mesh(**mesh_kw)
    batch = _batch(batch=4, image_size=cfg.image_size)
    kw = {}
    if pipeline:
        from dl_vqa_tpu.parallel.pipeline import PipelineContext

        kw["pipeline_ctx"] = PipelineContext(mesh, num_microbatches=2)
    with pytest.raises((ValueError, NotImplementedError)) as error:
        vqa.apply(vqa.init(jax.random.PRNGKey(0), cfg), cfg, batch["images"],
                  batch["questions"], batch["lengths"],
                  compute_dtype=jnp.float32,
                  seq_ctx=SequenceContext(mesh), **kw)
    return error


def test_the_cnn_raises_the_jax_models_error():
    from dl_vqa_tpu_torch.parallel.sequence import check_sequence_parallel

    cnn = _vit_dict()
    cnn["image"] = {"num_channels": [3, 4, 8], "dropout": 0.0}
    jax_error = _jax_apply_error(cnn, dict(data=2, model=1, seq=2))
    with pytest.raises(ValueError) as port_error:
        check_sequence_parallel(2, "cnn")
    assert str(port_error.value) == str(jax_error.value)


def test_tokens_the_axis_does_not_divide_raise_the_jax_models_error():
    """Nine tokens (24 px, patch 8) over 'seq' 2."""
    from dl_vqa_tpu_torch.parallel.sequence import SequenceContext

    jax_error = _jax_apply_error(_vit_dict(image_size=24),
                                 dict(data=2, model=1, seq=2))
    with pytest.raises(ValueError) as port_error:
        SequenceContext(None, 2, 0, (0, 1)).tokens(9)
    assert str(port_error.value) == str(jax_error.value)


def test_seq_with_stage_raises_the_jax_models_error():
    from dl_vqa_tpu_torch.parallel import make_mesh

    jax_error = _jax_apply_error(_vit_dict(), dict(data=2, model=1, stage=2),
                                 pipeline=True)
    with pytest.raises(NotImplementedError) as port_error:
        make_mesh(-1, seq=2, stage=2)
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("image", [
    {"moe_experts": 4}, {"store_dtype": "int8"}], ids=["moe", "int8"])
def test_seq_with_moe_or_a_quantized_mode_raises_naming_item_9(image):
    """'seq' with a ViT-MoE and with the int8 ViT are taken, as the JAX
    model takes them (the ranks run them:
    :func:`test_the_moe_steps_under_seq_are_one_processs` and
    :func:`test_the_int8_vit_under_seq_is_one_processs`); the CNN's
    quantized modes under 'seq' raise the JAX model's error."""
    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch.main import check_supported
    from dl_vqa_tpu_torch.parallel.sequence import NO_TOKEN_DIMENSION

    overrides = ["tpu.mesh.seq=2", "train.image.encoder=vit"] + [
        f"train.image.{k}={v}" for k, v in image.items()]
    check_supported(config.compose("config", overrides))
    with pytest.raises(ValueError) as error:
        check_supported(config.compose("config", overrides[:1] + [
            f"train.image.{k}={v}" for k, v in image.items()
            if k == "store_dtype"]))
    assert str(error.value) == NO_TOKEN_DIMENSION


def test_the_moe_routes_under_seq_are_one_processs(runs):
    """Top-2 gating of 3 groups of 16 tokens at a capacity of 5 (slots
    drop): the 'seq' ranks' routes of their 8 tokens each, put in their
    places, are one process's to the bit (experts, places, kept slots,
    weights), and their dense dispatch and combine are JAX's
    ``top_k_gating``'s."""
    import jax

    from dl_vqa_tpu.ops.moe import top_k_gating as jax_gating
    from dl_vqa_tpu_torch.ops.moe import Routing, top_k_gating

    logits = _logits()
    whole = top_k_gating(torch.from_numpy(logits), 2, 5)
    assert not bool(whole.kept.all())  # the capacity drops slots
    parts = {}
    for rank in runs["ranks"]:
        parts[tuple(rank["routes"]["tokens"])] = rank["routes"]
    assert sorted(parts) == [(0, 8), (8, 16)]
    got = {key: np.concatenate([np.asarray(parts[t][key])
                                for t in sorted(parts)], axis=1)
           for key in ("expert", "position", "kept", "weight")}
    for key in ("expert", "position", "kept", "weight"):
        np.testing.assert_array_equal(got[key],
                                      getattr(whole, key).numpy(),
                                      err_msg=key)
    dispatch, combine = Routing(
        *(torch.from_numpy(got[k]) for k in ("expert", "position", "kept",
                                             "weight")),
        None, None, None).dense(4, 5)
    want = jax.jit(jax_gating, static_argnums=(1, 2))(logits, 2, 5)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(combine.numpy(), np.asarray(want[1]),
                               atol=1e-6)


def _jax_moe_step(params):
    """JAX's seq-parallel train step of the ViT-MoE at 'data' 2 x 'seq'
    2."""
    import jax

    from dl_vqa_tpu.models import ModelConfig
    from dl_vqa_tpu.parallel import SequenceContext, batch_sharding, make_mesh
    from dl_vqa_tpu.train.state import create_train_state
    from dl_vqa_tpu.train.steps import make_optimizer, make_train_step

    cfg = ModelConfig.from_meta_dict(_vit_dict(moe=4))
    tx = make_optimizer(1e-3)
    mesh = make_mesh(data=2, model=1, seq=2)
    step = make_train_step(cfg, tx, compute_dtype=jax.numpy.float32,
                           seq_ctx=SequenceContext(mesh))
    batch = {k: jax.device_put(v, batch_sharding(mesh))
             for k, v in _batch(seed=6).items()}
    state, metrics = step(create_train_state(params, tx), batch,
                          jax.random.PRNGKey(11))
    return ([float(metrics["loss"]), float(metrics["score"]),
             float(metrics["moe_aux"])],
            _flatten(jax.tree_util.tree_map(np.asarray, state.params)))


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_the_moe_steps_under_seq_are_one_processs(runs, name):
    """One ViT-MoE train step at 'data' 2 x 'seq' 2 and at 'seq' 2 x
    'expert' 2: the loss, score and balance loss on every rank, and the
    parameters after the step, against the port's one process and JAX's
    seq-parallel step, at rel 1e-5 and atol 5e-5, rtol 5e-4."""
    expected, params = _jax_moe_step(runs["moe_params"])
    single, single_params = runs["single"]["moe"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[name], single, rtol=1e-5)
        np.testing.assert_allclose(rank[name], expected, rtol=1e-5)
    got = {k[len(name):]: v for k, v in runs["trained"]["moe"].items()
           if k.startswith(name + "/")}
    assert got.keys() == params.keys() == single_params.keys()
    for key, value in params.items():
        for want in (value, single_params[key]):
            np.testing.assert_allclose(got[key], want, atol=5e-5,
                                       rtol=5e-4, err_msg=key)


def test_the_int8_vit_under_seq_is_one_processs(runs):
    """The int8 ViT's eval step at 'data' 2 x 'seq' 2, calibrated on the
    whole model: each rank's image features are one process's bits for
    its rows (its W8A8 products are token-local), its loss and score one
    process's at rel 1e-5, and JAX's seq-parallel eval step's with the
    same scales."""
    import dataclasses

    import jax

    from dl_vqa_tpu.models import ModelConfig
    from dl_vqa_tpu.parallel import SequenceContext, batch_sharding, make_mesh
    from dl_vqa_tpu.train.steps import make_eval_step

    single, features, scales = runs["single"]["int8"]
    features = np.asarray(features, np.float32)
    cfg = ModelConfig.from_meta_dict(_vit_dict())
    cfg = dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, store_dtype="int8", quant_scales=tuple(scales)))
    mesh = make_mesh(data=2, model=1, seq=2)
    step = make_eval_step(cfg, compute_dtype=jax.numpy.float32,
                          seq_ctx=SequenceContext(mesh))
    batch = {k: jax.device_put(v, batch_sharding(mesh))
             for k, v in _batch(seed=5).items()}
    expected = [float(x) for x in step(runs["params"], batch)]
    for rank in runs["ranks"]:
        got, mine, rank_scales = rank["int8"]
        assert rank_scales == scales
        rows = slice(8, 16) if rank["rank"] >= 2 else slice(0, 8)
        np.testing.assert_array_equal(np.asarray(mine, np.float32),
                                      features[rows])
        np.testing.assert_allclose(got, single, rtol=1e-5)
        np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_the_token_dropout_keeps_the_whole_sequences_mask():
    """A 'seq' rank's dropout draws the mask of the whole batch and
    sequence and keeps its rows and tokens: one process's mask."""
    from dl_vqa_tpu_torch.models.layers import BatchRows, dropout

    x = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(1))
    whole = dropout(x, 0.3, torch.Generator().manual_seed(5))
    part = dropout(x[2:, 8:], 0.3, BatchRows(
        torch.Generator().manual_seed(5), 4, 2, tokens=16, token_start=8))
    assert torch.equal(part, whole[2:, 8:])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
