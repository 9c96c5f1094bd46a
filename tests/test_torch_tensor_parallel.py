"""The port's 'model' (tensor-parallel) and 'expert' (expert-parallel) mesh
axes (``dl_vqa_tpu_torch.parallel.tensor``): the placement rules against
the JAX package's, and gloo ranks on the CPU against the port's one
process and against the JAX train step on the same mesh.

One module fixture runs the one-process references in this process, then
spawns two groups of ranks at once (this file run by path as the worker,
joined by gloo, one thread each): two ranks ('model' = 2, or 'expert' =
2) and four ranks ('data' = 2 x 'model' = 2, and 'expert' = 2 x 'model' =
2). Each runs its scenarios once and writes what it saw: 3 train steps
of small models (widths 16, 16 answers, an even vocabulary of 30 ids so
that the embedding splits; f32 unless stated, dropout 0 unless stated) on
a batch of 8 whose last batch is padded to 5 real rows, and an eval step
of the fresh model; a ViT and a transformer text encoder of 3 heads among
them, whose attention 'model' = 2 keeps whole. The four ranks also run
the eval step of the quantized image modes (the CNN's f8 store and int8
stem, the int8 ViT), calibrated on the whole model before it is cut. The
two ranks also write a checkpoint, resume the one-process one, and run
``main`` and ``evaluate_vqa`` on a synthetic corpus.

Tolerances. Tensor parallelism sums the products of a split layer in
another order (two partial f32 sums and an all-reduce): losses and scores
are held at rtol 1e-5, atol 1e-6, and the parameters after 3 Adam steps
as ``tests/test_torch_parallel.py`` holds two 'data' ranks (its
``_assert_states_close``: atol 1e-4 where the gradient is clear of
rounding noise, Adam's bound elsewhere), against JAX at its
``JAX_PARAM_ATOL``. Expert parallelism alone sums each token's at most two
slot terms with the other rank's zeros: it is held to one process's bits,
in f32 and in bf16. What is replicated (the convs, the LSTM, the layer
norms, the router, the biases added after a reduction) is held bit-equal
across the ranks of a group, and ZeRO 1 and 3 to ZeRO 0's bits. The
quantized modes' image features are one process's bits (the int8 ViT's
row-parallel products sum their s32 partials), and their eval steps are
held to one process and to JAX's on the same mesh at rel 1e-5, as
``tests/test_sharding.py::test_int8_eval_under_dp_tp_mesh_matches`` holds
JAX's.
"""

import dataclasses
import glob
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import (
    JAX_PARAM_ATOL, LR, STEPS, TOL, _assert_states_close, _batches,
    _free_port, _state_of)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
BATCH = 8
CORPUS_BATCH = 16

# name -> (config overrides of the small model, its mesh)
TWO = {
    "cnn": ({}, {"model": 2}),
    "cnn_cat_dropout": ({"dropout": 0.3, "do_option": "|"}, {"model": 2}),
    "vit": ({"vit": True}, {"model": 2}),
    "san": ({"variant": "stacked", "do_option": "|"}, {"model": 2}),
    "transformer_co": ({"variant": "co", "transformer": True},
                       {"model": 2}),
    "heads3": ({"heads": 3, "transformer": True}, {"model": 2}),
    "moe_f32": ({"moe": 4}, {"expert": 2}),
    "moe_bf16": ({"moe": 4, "dtype": "bf16"}, {"expert": 2}),
}
FOUR = {
    "dp_tp_z0": ({}, {"data": 2, "model": 2, "zero": 0}),
    "dp_tp_z1": ({}, {"data": 2, "model": 2, "zero": 1}),
    "dp_tp_z3": ({}, {"data": 2, "model": 2, "zero": 3}),
    "ep_tp": ({"moe": 4}, {"expert": 2, "model": 2}),
}
# The quantized modes' eval steps at 'data' = 2 x 'model' = 2: name ->
# (config keywords, image.store_dtype).
QUANT = {"dp_tp_f8": ({}, "f8e4m3"), "dp_tp_int8": ({}, "int8"),
         "dp_tp_vit_int8": ({"vit": True}, "int8")}


def _cfg_dict(dropout=0.0, do_option="+", variant="single", vit=False,
              moe=0, transformer=False, dtype="f32", heads=2):
    """A small model; ``vit`` is a ViT of one block of two heads of 64 (so
    that kernels 4 and 5 run, a head on each rank), ``moe`` a ViT-MoE of
    one block of that many experts, top-2. ``heads`` other than 2 makes it
    a ViT of that many heads of 64 and a transformer text encoder (with
    ``transformer``) of that many heads of 8."""
    del dtype
    image = {"num_channels": [3, 4, 8], "dropout": dropout}
    if vit or moe or heads != 2:
        image.update(encoder="vit", num_channels=[3, 64 * heads],
                     patch_size=8, num_layers=1, num_heads=heads,
                     moe_experts=moe)
    text = {"question_features": 16 if heads == 2 else 8 * heads,
            "embedding_features": 8, "dropout": dropout}
    if transformer:
        text.update(encoder="transformer", num_heads=heads, num_layers=1,
                    max_positions=8)
    return {"text": text, "image": image,
            "attention": {"hidden_dim": 16, "glimpses": 2,
                          "dropout": dropout, "do_option": do_option,
                          "variant": variant},
            "classifier": {"hidden_dim": 16, "dropout": dropout},
            "max_answers": 16, "image_size": 32, "num_tokens": 30}


def _port_cfg(**kw):
    from dl_vqa_tpu_torch.models.configs import ModelConfig

    return ModelConfig.from_meta_dict(_cfg_dict(**kw))


def _dtype(kw):
    return torch.bfloat16 if kw.get("dtype") == "bf16" else torch.float32


def _fresh_state(cfg, mesh=None, stage=0, restore=None):
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.parallel.tensor import shard_state
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
        state = parallelize(shard_state(state, mesh), mesh, stage)
    return state


def _rows(batch, mesh):
    from dl_vqa_tpu_torch.parallel.multihost import process_batch_slice

    rows = None if mesh is None else process_batch_slice(mesh, BATCH)
    return batch if rows is None else {k: v[rows] for k, v in batch.items()}


def _train(cfg, batches, dtype=torch.float32, mesh=None, stage=0,
           state=None):
    from dl_vqa_tpu_torch.train import make_train_step

    state = state or _fresh_state(cfg, mesh, stage)
    step = make_train_step(cfg, dtype, mesh=mesh)
    out = {"loss": [], "score": [], "moe_aux": []}
    for batch in batches:
        state, metrics = step(state, _rows(batch, mesh), 7)
        for key in out:
            if key in metrics:
                out[key].append(float(metrics[key]))
    return out, state


def _eval(cfg, batches, model, dtype=torch.float32, mesh=None):
    from dl_vqa_tpu_torch.train import make_eval_step

    step = make_eval_step(cfg, dtype, with_breakdown=True, mesh=mesh)
    out = []
    for batch in batches:
        loss, score, sums, counts = step(model, _rows(batch, mesh))
        out.append([float(loss), float(score)] + sums.tolist()
                   + counts.tolist())
    return out


def _snapshot(state):
    from dl_vqa_tpu_torch.utils.checkpoint import host_snapshot

    return host_snapshot(state)


# ------------------------------------------------------------ the worker

def _local(state):
    """This rank's shards of 'model' and 'expert' (gathered over 'data'
    under ZeRO-3)."""
    from dl_vqa_tpu_torch.parallel.zero import _data_state

    return {k: v.detach().float().cpu().numpy()
            for k, v in _data_state(state)[0].items()}


def _scenarios(rank, world, out_dir):
    import torch.distributed as dist

    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.parallel.zero import full_state

    numbers, arrays = {"rank": rank, "world": world}, {}
    batches = _batches()
    for name, (kw, axes) in (TWO if world == 2 else FOUR).items():
        axes = dict(axes)
        stage = axes.pop("zero", 0)
        mesh = make_mesh(axes.pop("data", -1), device_type="cpu", **axes)
        cfg = _port_cfg(**kw)
        out, state = _train(cfg, batches, _dtype(kw), mesh, stage)
        numbers[name] = out
        numbers[name + "/eval"] = _eval(
            cfg, batches, _fresh_state(cfg, mesh, stage).model, _dtype(kw),
            mesh)
        snap = _snapshot(state)
        if rank == 0:
            arrays.update({f"{name}/{k}": v for k, v in snap.items()})
        numbers[name + "/whole"] = {
            k: list(v.shape) for k, v in full_state(state)[0].items()}
        np.savez(os.path.join(out_dir, f"local_{name}_{rank}.npz"),
                 **_local(state))
        dist.barrier()
    if world == 4:
        mesh = make_mesh(2, model=2, device_type="cpu")
        for name, (kw, store) in QUANT.items():
            numbers[name], features = _quant_eval(kw, store, mesh)
            arrays[f"{name}/features_{rank}"] = features
    return numbers, arrays


def _quant_model(kw, store, mesh=None):
    """The fresh model in a quantized mode, the int8 scales calibrated on
    the whole model (on the first batch's images) before it is cut for
    ``mesh``, as ``evaluate_vqa`` calibrates."""
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.parallel.tensor import shard_model

    cfg = _port_cfg(**kw)
    model = VqaNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    if store == "int8":
        cfg = model.int8_calibrated(_batches()[0]["images"],
                                    dtype=torch.float32)
    else:
        cfg = dataclasses.replace(cfg, image=dataclasses.replace(
            cfg.image, store_dtype=store))
    model.configure(cfg)
    if mesh is not None:
        shard_model(model, mesh)
    return cfg, model


def _quant_eval(kw, store, mesh=None):
    """The eval steps of a quantized mode and the image encoder's output
    (this rank's rows of the first batch)."""
    from dl_vqa_tpu_torch.models.layers import normalize_images

    cfg, model = _quant_model(kw, store, mesh)
    batches = _batches()
    images = _rows(batches[0], mesh)["images"]
    with torch.no_grad():
        features = model.image(normalize_images(
            torch.from_numpy(images), torch.float32), torch.float32, False,
            None)
    return _eval(cfg, batches, model, mesh=mesh), features.numpy()


def _checkpoints(rank, out_dir, resume_from):
    """'model' = 2: a checkpoint after two steps (the coordinator writes,
    every rank gathers) and its third step; the one-process checkpoint of
    step 2 resumed at 'model' = 2."""
    import torch.distributed as dist

    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    mesh = make_mesh(-1, model=2, device_type="cpu")
    cfg = _port_cfg()
    batches = _batches()
    numbers = {}
    out, state = _train(cfg, batches[:2], mesh=mesh)
    path = os.path.join(out_dir, "tp_step2.ckpt")
    if rank == 0:
        save_checkpoint(path, state, epoch=0)
    else:
        _snapshot(state)  # the coordinator's gather
    dist.barrier()
    out3, _ = _train(cfg, batches[2:], mesh=mesh, state=state)
    numbers["tp_steps"] = out["loss"] + out3["loss"]
    resumed = _fresh_state(cfg, mesh, restore=resume_from)
    numbers["resume_1_to_tp"] = _train(cfg, batches[2:], mesh=mesh,
                                       state=resumed)[0]["loss"]
    numbers["resume_1_to_tp/step"] = resumed.step
    return numbers


def _synced(rank):
    """Each rank's gradients set to its rank + 1, then synced: what
    'model' = 2 does not split takes rank 0's, the rest keeps its own."""
    from dl_vqa_tpu_torch.parallel import make_mesh
    from dl_vqa_tpu_torch.parallel.tensor import sync_replicated_grads

    mesh = make_mesh(-1, model=2, device_type="cpu")
    model = _fresh_state(_port_cfg(), mesh).model
    for p in model.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    sync_replicated_grads(model, mesh)
    return {n: float(p.grad.mean()) for n, p in model.named_parameters()
            if p.grad is not None}


def _corpus_overrides(root, logs):
    profile = json.load(open(os.path.join(root, "profile.json")))
    ov = ["main.use_full=false"]
    for group, paths in profile.items():
        ov += [f"main.small.{group}.{k}={v}" for k, v in paths.items()]
    return ov + [
        f"main.small.paths.logs={logs}/", "train.num_epochs=1",
        f"train.batch_size={CORPUS_BATCH}", "train.max_answers=8",
        "train.image_size=20", "train.text.question_features=16",
        "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 8]",
        "train.attention.hidden_dim=16", "train.classifier.hidden_dim=16",
        "tpu.compute_dtype=float32"]


def _entry_points(root, mesh_overrides):
    """``main`` for an epoch and ``evaluate_vqa`` of its checkpoint."""
    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2
    from dl_vqa_tpu_torch.main import main

    tag = "tp" if mesh_overrides else "single"
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
    return {"best": best, "eval": score, "ckpt": ckpt}


def _worker(rank, world, port, out_dir, resume_from, root):
    import torch.distributed as dist

    from dl_vqa_tpu_torch import config
    from dl_vqa_tpu_torch.main import main

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    numbers, arrays = _scenarios(rank, world, out_dir)
    if world == 2:
        numbers.update(_checkpoints(rank, out_dir, resume_from))
        numbers["synced"] = _synced(rank)
        numbers["entry"] = _entry_points(root, ["tpu.mesh.model=2"])
        try:
            main(config.compose("config", _corpus_overrides(
                root, os.path.join(root, "logs_refused"))
                + ["tpu.mesh.expert=2"]), device="cpu")
        except SystemExit as refusal:
            numbers["expert_without_moe"] = str(refusal)
    with open(os.path.join(out_dir, f"rank{rank}_of{world}.json"), "w") as f:
        json.dump(numbers, f)
    np.savez(os.path.join(out_dir, f"arrays_of{world}_{rank}.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------ the fixture

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks started, then the one-process references while they run,
    then the ranks' results."""
    from dl_vqa_tpu.data import synthetic
    from dl_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    root = str(tmp_path_factory.mktemp("corpus"))
    profile = synthetic.make_synthetic_corpus(
        root, n_train=44, n_val=20, n_images=6, image_size=20,
        max_answers=8, learnable=True)
    with open(os.path.join(root, "profile.json"), "w") as f:
        json.dump(profile, f)
    batches = _batches()
    cfg = _port_cfg()
    out, state = _train(cfg, batches[:2])
    resume_from = os.path.join(out_dir, "single_step2.ckpt")
    save_checkpoint(resume_from, state, epoch=0)
    step2 = _snapshot(state)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for world in (2, 4):
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, HERE, "--worker", str(rank), str(world),
             str(port), out_dir, resume_from, root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, env=env) for rank in range(world)]
    # The ranks run one thread each, and so do the references: a CPU
    # product's bits may depend on its threads.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {"step2": step2}
        for name, (kw, _) in {**TWO, **FOUR}.items():
            cfg = _port_cfg(**kw)
            if name.startswith("dp_tp_z") and name != "dp_tp_z0":
                single[name] = single["dp_tp_z0"]
                continue
            got, state = _train(cfg, batches, _dtype(kw))
            single[name] = (got, _snapshot(state), _eval(
                cfg, batches, _fresh_state(cfg).model, _dtype(kw)))
        for name, (kw, store) in QUANT.items():
            single[name] = _quant_eval(kw, store)
        single["entry"] = _entry_points(root, [])
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    ranks = {world: [json.load(open(os.path.join(
        out_dir, f"rank{r}_of{world}.json"))) for r in range(world)]
        for world in (2, 4)}
    arrays = {}
    for world in (2, 4):
        for rank in range(world):
            with np.load(os.path.join(out_dir,
                                      f"arrays_of{world}_{rank}.npz")) as data:
                arrays.update({key: data[key] for key in data.files
                               if rank == 0 or "/features_" in key})
    return {"single": single, "ranks": ranks, "arrays": arrays,
            "dir": out_dir, "root": root, "batches": batches}


def _world_of(name):
    return 2 if name in TWO else 4


def _locals(runs, name):
    world = _world_of(name)
    out = []
    for rank in range(world):
        with np.load(os.path.join(runs["dir"],
                                  f"local_{name}_{rank}.npz")) as data:
            out.append({k: data[k] for k in data.files})
    return out


# ------------------------------------------------------------ the rules

def _jax_tree(kw):
    """The JAX parameter tree of the small model (shapes only)."""
    import jax

    from dl_vqa_tpu.models import vqa
    from dl_vqa_tpu.models.configs import ModelConfig as JaxModelConfig

    cfg = JaxModelConfig.from_meta_dict(_cfg_dict(**kw))
    return jax.eval_shape(lambda: vqa.init(jax.random.PRNGKey(0), cfg))


def _jax_specs(tree, **mesh_kw):
    import jax

    from dl_vqa_tpu.parallel import make_mesh as jax_make_mesh
    from dl_vqa_tpu.parallel import param_shardings

    mesh = jax_make_mesh(devices=jax.devices()[:8], **mesh_kw)
    shardings = param_shardings(tree, mesh)
    sizes = dict(mesh.shape)

    def norm(sharding):
        spec = tuple(a if a is not None and sizes[a] > 1 else None
                     for a in sharding.spec)
        return () if all(a is None for a in spec) else spec

    return jax.tree_util.tree_map(norm, shardings), sizes


MODELS = {"cnn": {}, "vit": {"vit": True}, "vit_moe": {"moe": 4},
          "san": {"variant": "stacked"},
          "transformer_co": {"variant": "co", "transformer": True}}


@pytest.mark.parametrize("mesh", [{"model": 2}, {"expert": 2, "model": 2}],
                         ids=["model2", "expert2_model2"])
@pytest.mark.parametrize("model", list(MODELS))
def test_the_placement_rules_are_jaxs_on_every_leaf(model, mesh):
    """The port's copy of the rules gives every leaf of the five models
    the spec ``dl_vqa_tpu.parallel.param_shardings`` gives it on the
    conftest's 8 virtual devices (the 'data' axis takes the rest)."""
    import jax

    from dl_vqa_tpu_torch.parallel.mesh import param_specs

    tree = _jax_tree(MODELS[model])
    want, sizes = _jax_specs(tree, data=-1, **mesh)
    got = param_specs(tree, sizes)
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))[0])
    assert len(flat_got) == len(flat_want)
    for path, spec in flat_want:
        assert flat_got[path] == spec, jax.tree_util.keystr(path)
    assert any(spec for _, spec in flat_want)


def test_the_odd_reference_vocabulary_replicates_and_warns(caplog):
    """At the reference width with its odd 15,193 ids the embedding cannot
    split its rows over 'model' = 2: both packages replicate it and warn of
    the same leaves, in the JAX words."""
    import dataclasses

    import jax

    from dl_vqa_tpu.models import vqa
    from dl_vqa_tpu.models.configs import ModelConfig as JaxModelConfig
    from dl_vqa_tpu_torch.parallel.mesh import param_specs

    cfg = dataclasses.replace(JaxModelConfig(), num_tokens=15_193)
    tree = jax.eval_shape(lambda: vqa.init(jax.random.PRNGKey(0), cfg))
    with caplog.at_level(logging.WARNING):
        want, sizes = _jax_specs(tree, data=4, model=2)
        got = param_specs(tree, sizes)
    assert want["text"]["embedding"] == got["text"]["embedding"] == ()
    assert got["classifier"]["lin1"]["w"] == (None, "model")
    jax_warned = [r.getMessage() for r in caplog.records
                  if r.name == "dl_vqa_tpu.parallel.mesh"]
    port_warned = [r.getMessage() for r in caplog.records
                   if r.name == "dl_vqa_tpu_torch.parallel.mesh"]
    assert len(jax_warned) == len(port_warned) == 1
    assert "tensor-parallel fallback to replication" in port_warned[0]
    assert "/text/embedding shape=(15193, 300)" in port_warned[0]
    assert "/text/embedding shape=(15193, 300)" in jax_warned[0]
    # The even vocabulary of the reference tests splits, silently.
    caplog.clear()
    even = dataclasses.replace(cfg, num_tokens=15_194)
    tree = jax.eval_shape(lambda: vqa.init(jax.random.PRNGKey(0), even))
    with caplog.at_level(logging.WARNING):
        assert param_specs(tree, sizes)["text"]["embedding"] == (
            "model", None)
    assert not caplog.records


def test_a_head_count_the_model_axis_does_not_divide_raises(caplog):
    """'model' = 2 over blocks of three heads: the port splits a packed
    ``qkv`` by heads, so the ViT's and the text encoder's ``qkv`` and
    ``out`` keep the rules' fallback (replicated, the large ones warned of
    in the JAX words) and their MLPs split, where JAX splits ``qkv`` by
    columns. Nothing raises (the ranks run it:
    :func:`test_three_heads_keep_their_attention_whole`)."""
    from dl_vqa_tpu_torch.parallel.mesh import param_specs

    tree = _jax_tree({"heads": 3, "transformer": True})
    jax_specs, sizes = _jax_specs(tree, data=-1, model=2)
    with caplog.at_level(logging.WARNING):
        got = param_specs(tree, sizes, heads={"image": 3, "text": 3})
    image, text = got["image"]["layers"], got["text"]["layers"][0]
    assert jax_specs["image"]["layers"]["qkv"]["w"] == (None, None, "model")
    for block in (image, text):
        assert block["qkv"]["w"] == block["qkv"]["b"] == ()
        assert block["out"]["w"] == ()
    assert image["mlp_in"]["w"] == (None, None, "model")
    assert image["mlp_out"]["w"] == (None, "model", None)
    assert text["mlp_in"]["w"] == (None, "model")
    (warned,) = [r.getMessage() for r in caplog.records
                 if r.name == "dl_vqa_tpu_torch.parallel.mesh"]
    assert "tensor-parallel fallback to replication" in warned
    assert "/image/layers/qkv/w shape=(1, 192, 576)" in warned
    assert "/text/" not in warned  # under WARN_FALLBACK_ELEMENTS
    # Two heads divide: the JAX rules' specs, silently.
    assert param_specs(tree, sizes, heads={"image": 2, "text": 2}) == \
        param_specs(tree, sizes)


def test_fused_ops_on_the_vit_under_model_raise():
    """Kernel 8 fuses the MLP that 'model' splits: the steps refuse
    ``fused_ops`` with a ViT on a mesh of 'model' above 1, naming ROADMAP
    queue 2's kernel work (the port's own option, which the JAX package
    lacks); the CNN's fused blocks and a mesh of 'model' 1 are taken."""
    from dl_vqa_tpu_torch.parallel.mesh import Mesh
    from dl_vqa_tpu_torch.train import make_eval_step, make_train_step

    tp = Mesh({"data": 1, "model": 2})
    for make in (make_eval_step, make_train_step):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            make(_port_cfg(vit=True), fused_ops=True, mesh=tp)
        make(_port_cfg(), fused_ops=True, mesh=tp)
        make(_port_cfg(vit=True), fused_ops=True,
             mesh=Mesh({"data": 1, "model": 1}))


# ------------------------------------------------------------ the ranks

def _replicated_bit_equal(locals_, whole, groups):
    """Every tensor that a group's ranks hold whole (its shape the whole
    state's) is the same bits on each; returns how many were compared."""
    compared = 0
    for group in groups:
        first = locals_[group[0]]
        for name, value in first.items():
            if list(value.shape) != whole[name]:
                continue
            for other in group[1:]:
                np.testing.assert_array_equal(locals_[other][name], value,
                                              err_msg=name)
                compared += 1
    return compared


def _hold_to_single(runs, name, what=None):
    got = runs["ranks"][_world_of(name)][0][name]
    expected, expected_state, expected_eval = runs["single"][name]
    for key in ("loss", "score", "moe_aux"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=f"{name}: {key}")
    _assert_states_close(_state_of(runs["arrays"], name), expected_state,
                         STEPS, what or name)
    np.testing.assert_allclose(runs["ranks"][_world_of(name)][0][
        name + "/eval"], expected_eval, **TOL)


@pytest.mark.parametrize("name", ["cnn", "cnn_cat_dropout", "vit", "san",
                                  "transformer_co", "heads3"])
def test_model_2_equals_one_process(runs, name):
    """Two ranks of 'model' = 2: losses, scores, the eval step, and the
    gathered state after 3 steps (the one-process npz layout) against one
    process, at the module's tolerances. Dropout 0.3 with the '|' fusion:
    each rank keeps its columns of the whole mask at the column-split
    sites (the fused tensor, the classifier's hidden), so the masks are
    the one process's."""
    _hold_to_single(runs, name)
    r0, r1 = runs["ranks"][2]
    assert r0[name] == r1[name] and r0[name + "/eval"] == r1[name + "/eval"]


@pytest.mark.parametrize("name", ["cnn", "vit", "moe_f32", "dp_tp_z0",
                                  "dp_tp_z1", "dp_tp_z3", "ep_tp"])
def test_replicated_parameters_are_the_same_bits_on_every_rank(runs, name):
    """After 3 steps, what a group's ranks hold whole (convs, LSTM, layer
    norms, the MoE router, the biases added after a reduction) is the same
    bits on each, and the ranks of a 'data' group (the same shards) hold
    the same bits of everything."""
    locals_ = _locals(runs, name)
    world = len(locals_)
    whole = runs["ranks"][world][0][name + "/whole"]
    assert any(list(v.shape) != whole[k] for k, v in locals_[0].items())
    if name.startswith("dp_tp"):
        # ranks (d, m): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
        assert _replicated_bit_equal(locals_, whole, [[0, 1], [2, 3]]) > 10
        for a, b in ((0, 2), (1, 3)):
            for key, value in locals_[a].items():
                np.testing.assert_array_equal(locals_[b][key], value,
                                              err_msg=key)
    else:
        assert _replicated_bit_equal(locals_, whole,
                                     [list(range(world))]) > 5
    assert world == _world_of(name)


def test_each_rank_holds_its_shards(runs):
    """'model' = 2 halves the classifier's lin1 and lin2, the attention's
    projections and the embedding's rows; a ViT block holds one of its two
    heads' q, k and v columns; 'expert' = 2 holds two of the four
    experts."""
    cnn = _locals(runs, "cnn")[0]
    assert cnn["classifier.lin1.weight"].shape == (8, 48)
    assert cnn["classifier.lin2.weight"].shape == (16, 8)
    assert cnn["classifier.lin2.bias"].shape == (16,)
    assert cnn["attention.v_conv.weight"].shape == (8, 8, 1, 1)
    assert cnn["attention.x_conv.weight"].shape == (2, 16, 1, 1)
    assert cnn["text.embedding.weight"].shape == (15, 8)
    vit = _locals(runs, "vit")
    assert vit[0]["image.blocks.0.qkv.weight"].shape == (192, 128)
    assert vit[0]["image.blocks.0.out.weight"].shape == (128, 64)
    whole = _state_of(runs["arrays"], "vit")["params|image|layers|qkv|w"]
    for rank, local in enumerate(vit):
        cols = np.concatenate([np.arange(64) + 64 * rank + 128 * part
                               for part in range(3)])
        np.testing.assert_array_equal(
            local["image.blocks.0.qkv.weight"], whole[0][:, cols].T)
    moe = _locals(runs, "moe_f32")
    assert moe[0]["image.blocks.0.moe.in.weight"].shape == (2, 512, 128)
    assert moe[0]["image.blocks.0.moe.gate"].shape == (4, 128)
    ep_tp = _locals(runs, "ep_tp")[3]
    assert ep_tp["image.blocks.0.moe.in.weight"].shape == (2, 256, 128)
    assert ep_tp["image.blocks.0.moe.out.weight"].shape == (2, 128, 256)
    assert ep_tp["image.blocks.0.moe.out.bias"].shape == (2, 128)


def test_three_heads_keep_their_attention_whole(runs):
    """'model' = 2 over a ViT and a text encoder of three heads: each rank
    holds ``qkv`` and ``out`` whole, the same bits on both, and half of
    each MLP."""
    locals_ = _locals(runs, "heads3")
    for local in locals_:
        assert local["image.blocks.0.qkv.weight"].shape == (576, 192)
        assert local["image.blocks.0.out.weight"].shape == (192, 192)
        assert local["image.blocks.0.mlp_in.weight"].shape == (384, 192)
        assert local["text.blocks.0.qkv.weight"].shape == (72, 24)
        assert local["text.blocks.0.mlp_in.weight"].shape == (48, 24)
    for key in ("image.blocks.0.qkv.weight", "text.blocks.0.out.weight"):
        np.testing.assert_array_equal(locals_[0][key], locals_[1][key])


def _jax_quant_eval(runs, name):
    """JAX's eval step of the mode on a 'data' 2 x 'model' 2 mesh of
    virtual devices, its parameters placed by the JAX rules, with the
    port's initial parameters and the port's int8 scales."""
    import jax

    from dl_vqa_tpu.models.configs import ModelConfig as JaxModelConfig
    from dl_vqa_tpu.parallel import (
        batch_sharding, make_mesh, param_shardings)
    from dl_vqa_tpu.train.steps import make_eval_step
    from dl_vqa_tpu_torch.utils.params import jax_params_from_model

    kw, store = QUANT[name]
    cfg, model = _quant_model(kw, store)
    params = jax_params_from_model(model)
    jax_cfg = JaxModelConfig.from_meta_dict(_cfg_dict(**kw))
    jax_cfg = dataclasses.replace(jax_cfg, image=dataclasses.replace(
        jax_cfg.image, store_dtype=store,
        quant_scales=cfg.image.quant_scales))
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    placed = jax.device_put(params, param_shardings(params, mesh))
    step = make_eval_step(jax_cfg, compute_dtype=jax.numpy.float32)
    out = []
    for batch in runs["batches"]:
        sharded = {k: jax.device_put(v, batch_sharding(mesh))
                   for k, v in batch.items() if k != "answer_types"}
        loss, score = step(placed, sharded)
        out.append([float(loss), float(score)])
    return out


@pytest.mark.parametrize("name", list(QUANT))
def test_the_quantized_modes_at_data_2_model_2(runs, name):
    """The f8 store, the int8 stem and the int8 ViT at 'data' 2 x 'model'
    2, calibrated on the whole model: the image features on each rank are
    one process's bits for its rows; the eval steps the same on every
    rank, one process's at TOL and JAX's on the same mesh at rel 1e-5."""
    ranks = runs["ranks"][4]
    assert all(r[name] == ranks[0][name] for r in ranks)
    single, features = runs["single"][name]
    np.testing.assert_allclose(ranks[0][name], single, **TOL)
    for rank in range(4):
        rows = slice((rank // 2) * BATCH // 2, (rank // 2 + 1) * BATCH // 2)
        np.testing.assert_array_equal(
            runs["arrays"][f"{name}/features_{rank}"], features[rows])
    np.testing.assert_allclose(np.asarray(ranks[0][name])[:, :2],
                               _jax_quant_eval(runs, name), rtol=1e-5)


@pytest.mark.parametrize("name", ["moe_f32", "moe_bf16"])
def test_expert_2_gives_one_process_bits(runs, name):
    """'expert' = 2 on the ViT-MoE (4 experts, top-2): each token's
    combined value is at most two slot terms, the other rank's zeros
    added exactly, so losses, scores, balance losses, the eval step and
    the gathered state after 3 steps are one process's bits, in f32 and
    in bf16."""
    got = runs["ranks"][2][0][name]
    expected, expected_state, expected_eval = runs["single"][name]
    assert got == expected and len(got["moe_aux"]) == STEPS
    assert runs["ranks"][2][0][name + "/eval"] == expected_eval
    state = _state_of(runs["arrays"], name)
    assert state.keys() == expected_state.keys()
    for key, value in expected_state.items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_data_2_model_2_equals_one_process(runs, stage):
    """Four ranks, 'data' = 2 x 'model' = 2, the last batch's 5 real rows
    falling 4 and 1 over the 'data' shards: each ZeRO stage against one
    process at the module's tolerances, and ZeRO 1 and 3 to ZeRO 0's
    bits (the wrappers run over the 'data' group on each rank's
    shards)."""
    name = f"dp_tp_z{stage}"
    _hold_to_single(runs, name)
    ranks = runs["ranks"][4]
    assert all(r[name] == ranks[0][name] for r in ranks)
    if stage:
        assert ranks[0][name] == ranks[0]["dp_tp_z0"]
        base = _state_of(runs["arrays"], "dp_tp_z0")
        for key, value in _state_of(runs["arrays"], name).items():
            np.testing.assert_array_equal(value, base[key], err_msg=key)


def test_expert_2_model_2_equals_one_process(runs):
    """Four ranks, 'expert' = 2 x 'model' = 2 on the ViT-MoE: the experts
    split over 'expert', each expert's hidden width and the block's
    products over 'model'."""
    _hold_to_single(runs, "ep_tp")


def test_replicated_gradients_are_synced_to_rank_0s(runs):
    """Before each update the ranks take the coordinate-0 rank's gradients
    of what their axis does not split (a library kernel may compute them
    to other bits on each rank): set to rank + 1, the replicated ones are
    1 on both ranks and the split ones keep their rank's value."""
    for rank, r in enumerate(runs["ranks"][2]):
        got = r["synced"]
        for name in ("image.conv0.weight", "text.lstm.weight_hh_l0",
                     "attention.x_conv.weight", "classifier.lin2.bias"):
            assert got[name] == 1.0, (rank, name)
        for name in ("classifier.lin1.weight", "classifier.lin2.weight",
                     "attention.v_conv.weight", "text.embedding.weight"):
            assert got[name] == rank + 1.0, (rank, name)


def test_a_tp_checkpoint_is_the_one_process_checkpoint(runs):
    """The file two 'model' ranks write after 2 steps (every rank gathers,
    the coordinator writes) holds the one-process arrays, and resumes:
    2 -> 1 (restored in one process) and 1 -> 2 (the one-process
    checkpoint cut at 'model' = 2) each take step 3 as the unbroken run
    does."""
    from dl_vqa_tpu_torch.utils.checkpoint import load_checkpoint

    path = os.path.join(runs["dir"], "tp_step2.ckpt")
    flat, meta = load_checkpoint(path)
    assert meta["epoch"] == 0 and int(flat["step"]) == 2
    _assert_states_close(flat, runs["single"]["step2"], 2, "tp ckpt")
    unbroken = runs["single"]["cnn"][0]["loss"]
    cfg = _port_cfg()
    state = _fresh_state(cfg, restore=path)
    out, _ = _train(cfg, runs["batches"][2:], state=state)
    np.testing.assert_allclose(out["loss"], unbroken[2:], **TOL)
    r0 = runs["ranks"][2][0]
    assert r0["resume_1_to_tp/step"] == STEPS
    np.testing.assert_allclose(r0["resume_1_to_tp"], unbroken[2:], **TOL)
    np.testing.assert_allclose(r0["tp_steps"], unbroken, **TOL)


def test_the_entry_points_at_model_2(runs):
    """``main`` for an epoch and ``evaluate_vqa`` of its checkpoint at
    ``tpu.mesh.model=2`` over two gloo ranks: the one-process best
    accuracy and score, on both ranks; only the coordinator writes a run
    directory. ``tpu.mesh.expert=2`` on the CNN exits with the JAX
    package's words."""
    ranks = runs["ranks"][2]
    single = runs["single"]["entry"]
    for r in ranks:
        assert r["entry"]["best"] == pytest.approx(single["best"], abs=1e-6)
        assert r["entry"]["eval"] == single["eval"]
        assert "expert-major" in r["expert_without_moe"]
    for logs in ("logs_tp", "logs_tp_eval"):
        dirs = glob.glob(os.path.join(runs["root"], logs, "*"))
        exp = [d for d in dirs if os.path.basename(d) != "tensorboard"]
        assert len(exp) == 1, dirs
        names = os.listdir(exp[0])
        assert sum(n.endswith(".log") for n in names) == 1, names
    assert "model.ckpt" in os.listdir(os.path.dirname(
        ranks[0]["entry"]["ckpt"]))


# ------------------------------------------------------------ against JAX

def _jax_run(cfg_dict, params, batches, mesh_kw, zero_stage=0):
    """The JAX train step on a mesh of the conftest's virtual devices,
    the state placed by ``state_shardings``."""
    import jax
    import jax.numpy as jnp

    from dl_vqa_tpu.models.configs import ModelConfig as JaxModelConfig
    from dl_vqa_tpu.parallel import (
        batch_sharding, make_mesh, param_shardings, state_shardings)
    from dl_vqa_tpu.train.state import create_train_state
    from dl_vqa_tpu.train.steps import make_optimizer, make_train_step

    cfg = JaxModelConfig.from_meta_dict(cfg_dict)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = make_mesh(devices=jax.devices()[:n], **mesh_kw)
    tx = make_optimizer(LR)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               tx)
    state = jax.device_put(state, state_shardings(
        state, param_shardings(params, mesh), mesh, zero_stage=zero_stage))
    step = make_train_step(cfg, tx, compute_dtype=jnp.float32)
    out = {"loss": [], "score": []}
    for batch in batches:
        placed = {k: jax.device_put(v, batch_sharding(mesh))
                  for k, v in batch.items()}
        state, metrics = step(state, placed, jax.random.PRNGKey(0))
        for key in out:
            out[key].append(float(metrics[key]))
    return out, state


@pytest.mark.parametrize("name,mesh_kw,stage", [
    ("cnn", {"data": 1, "model": 2}, 0),
    ("vit", {"data": 1, "model": 2}, 0),
    ("heads3", {"data": 1, "model": 2}, 0),
    ("moe_f32", {"data": 1, "model": 1, "expert": 2}, 0),
    ("dp_tp_z0", {"data": 2, "model": 2}, 0),
    ("dp_tp_z1", {"data": 2, "model": 2}, 1),
    ("dp_tp_z3", {"data": 2, "model": 2}, 3),
    ("ep_tp", {"data": 1, "model": 2, "expert": 2}, 0),
])
def test_the_ranks_equal_jax_on_the_same_mesh(runs, name, mesh_kw, stage):
    """The same initial parameters (the port's, through
    ``utils/params.py``) and batches through the JAX train step on the
    same mesh of virtual devices, its state placed by the JAX rules (and
    ZeRO stage): the ranks' losses and scores at TOL, their gathered state
    as ``_assert_states_close`` holds it at ``JAX_PARAM_ATOL``."""
    from dl_vqa_tpu.utils.checkpoint import _flatten
    from dl_vqa_tpu_torch.utils.params import jax_params_from_model

    kw = (TWO if name in TWO else FOUR)[name][0]
    cfg = _port_cfg(**kw)
    params = jax_params_from_model(_fresh_state(cfg).model)
    expected, state = _jax_run(_cfg_dict(**kw), params, runs["batches"],
                               mesh_kw, stage)
    got = runs["ranks"][_world_of(name)][0][name]
    for key in ("loss", "score"):
        np.testing.assert_allclose(got[key], expected[key], **TOL,
                                   err_msg=key)
    _assert_states_close(_state_of(runs["arrays"], name), _flatten(state),
                         STEPS, f"{name} against JAX",
                         param_atol=JAX_PARAM_ATOL)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5], sys.argv[6], sys.argv[7])
