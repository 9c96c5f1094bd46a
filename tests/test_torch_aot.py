"""The port's serving kernels as ``torch.library`` custom ops and its AOT
serving artifact (``dl_vqa_tpu_torch/utils/aot_export.py``), on the CPU
at small widths.

Every ``vqa::`` op passes ``torch.library.opcheck`` on CPU tensors (its
plain version). The exported program of each serving configuration holds
exactly the ``vqa::`` nodes the live forward dispatches and none of the
ATen ops that only the kernels' plain versions use; its logits are the
live Predictor's to the bit, in f32 and in bf16; it holds no weight. The
port's artifact against the JAX package's (``dl_vqa_tpu.utils.aot_export``,
the same weights carried over, f32) at ``tests/test_torch_model.py``'s
tolerance: atol 2e-5, rtol 1e-4. Then the artifact's contract: layout,
padding and splitting, answer decoding, a loader process that imports no
model code, and the loud refusal of another device."""

import collections
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.library import opcheck

from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.utils import aot_export as jax_aot
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.predict import Predictor
from dl_vqa_tpu_torch.utils.aot_export import (
    ARTIFACT_VERSION, OP_MODULES, load_artifact)
from dl_vqa_tpu_torch.utils.params import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 6          # max question length
SIZE = 40      # image size
TOKENS = 8
ANSWERS = 5
BUCKETS = (2, 4)
# ATen ops that only the hand kernels' plain versions call on this path:
# the pools' amax and max_pool2d, the LSTM cell's sigmoid, the softmax of
# the glimpse pooling and of the ViT attention, the pooling's einsum.
PLAIN_ONLY = {"aten.amax.default", "aten.max_pool2d.default",
              "aten.sigmoid.default", "aten.softmax.int",
              "aten._softmax.default", "aten.einsum.default"}


def _jax_cfg():
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=0.0),
        image=ImageConfig(num_channels=(3, 16, 32), dropout=0.0),
        attention=AttentionConfig(hidden_dim=12, glimpses=2, dropout=0.0),
        classifier=ClassifierConfig(hidden_dim=10, dropout=0.0),
        max_answers=ANSWERS, image_size=SIZE, num_tokens=TOKENS)


def _cfg(encoder="cnn", store="compute", text="lstm", variant="single",
         moe=0):
    """The CNN (a stem of Cin 3, then a block of Cin 16: both fused ops
    take part) or a ViT of one 64-wide head, 2 layers, patch 8 (with
    ``moe`` experts in every block, top-2); the bi-LSTM or the transformer
    text encoder (2 layers of 8 heads); the single, stacked or co
    attention."""
    cfg = ModelConfig.from_meta_dict(dataclasses.asdict(_jax_cfg()))
    image = dataclasses.replace(cfg.image, store_dtype=store)
    if encoder == "vit":
        image = dataclasses.replace(image, encoder="vit",
                                    num_channels=(3, 64), patch_size=8,
                                    num_layers=2, num_heads=1,
                                    moe_experts=moe)
    return dataclasses.replace(
        cfg, image=image,
        text=dataclasses.replace(cfg.text, encoder=text),
        attention=dataclasses.replace(cfg.attention, variant=variant))


def _vocab():
    return {"question": {f"w{i}": i + 1 for i in range(TOKENS - 1)},
            "answer": {f"ans{i}": i + 1 for i in range(ANSWERS)}}


def _inputs(n, seed=0):
    """Normalised f32 images, ids, and lengths 0 .. L (0 is clamped)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, TOKENS, (n, L)).astype(np.int32),
            rng.integers(0, L + 1, (n,)).astype(np.int32))


def _predictor(encoder="cnn", dtype=torch.bfloat16, fused=False,
               store="compute", text="lstm", variant="single", moe=0):
    cfg = _cfg(encoder, store, text, variant, moe)
    model = VqaNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    predictor = Predictor(cfg, model, _vocab(), device="cpu",
                          max_question_length=L, compute_dtype=dtype,
                          fused_ops=fused)
    if store == "int8":
        predictor.calibrate_int8(_inputs(4, seed=9)[0])
    return predictor


# Each serving configuration and the vqa:: nodes of one forward.
CONFIGS = {
    "cnn": (dict(), {"lstm_recurrence": 1, "relu_maxpool": 2,
                     "attention_pool": 1}),
    "cnn_fused": (dict(fused=True), {"lstm_recurrence": 1,
                                     "conv_relu_pool_stem": 1,
                                     "conv_relu_pool_fused": 1,
                                     "attention_pool": 1}),
    "vit_fused": (dict(encoder="vit", fused=True),
                  {"lstm_recurrence": 1, "vit_attention": 2,
                   "fused_ln_mlp": 2, "attention_pool": 1}),
    "cnn_int8": (dict(store="int8"), {"lstm_recurrence": 1,
                                      "relu_maxpool": 1,
                                      "conv_relu_pool_w8a8": 1,
                                      "attention_pool": 1}),
    "cnn_f8": (dict(store="f8e4m3"), {"lstm_recurrence": 1,
                                      "relu_maxpool": 2,
                                      "attention_pool": 1}),
    "cnn_f32": (dict(dtype=torch.float32), {"lstm_recurrence": 1,
                                            "relu_maxpool": 2,
                                            "attention_pool": 1}),
    "vit_f32": (dict(encoder="vit", dtype=torch.float32),
                {"lstm_recurrence": 1, "vit_attention": 2,
                 "attention_pool": 1}),
    # The variants: kernel 3 a glimpse in stacked attention; the per-token
    # states of the (lstm, co) text path on kernel A's f32 mode; no LSTM
    # with the transformer.
    "san": (dict(variant="stacked"), {"lstm_recurrence": 1,
                                      "relu_maxpool": 2,
                                      "attention_pool": 2}),
    "lstm_co": (dict(variant="co"), {"lstm_token_states": 1,
                                     "relu_maxpool": 2,
                                     "attention_pool": 1}),
    "transformer_co": (dict(text="transformer", variant="co"),
                       {"relu_maxpool": 2, "attention_pool": 1}),
    # The ViT-MoE: kernel 4 a block, the experts in ATen ops (their static
    # [E, G, C, D] buffer exports); with fused_ops its blocks stay on the
    # MoE path, so no kernel 8.
    "vit_moe_fused": (dict(encoder="vit", moe=4, fused=True),
                      {"lstm_recurrence": 1, "vit_attention": 2,
                       "attention_pool": 1}),
}
# The ATen ops of PLAIN_ONLY that a variant's own layers call: the
# softmax of co-attention's token weights, of the transformer's
# self-attention and of the MoE router.
VARIANT_ATEN = dict.fromkeys(("lstm_co", "transformer_co", "vit_moe_fused"),
                             {"aten.softmax.int", "aten._softmax.default"})


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``{name: (predictor, artifact dir)}``, exported once a module."""
    root = tmp_path_factory.mktemp("aot")
    out = {}

    def get(name):
        if name not in out:
            predictor = _predictor(**CONFIGS[name][0])
            path = str(root / name)
            predictor.export_artifact(path, batch_sizes=BUCKETS)
            out[name] = predictor, path
        return out[name]

    return get


# -- the ops ---------------------------------------------------------------

def _op_cases():
    """``{case: (op, args)}``: each op on CPU tensors, kernel 2 in each of
    its modes."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    codes = torch.randint(0, 128, (2, 9, 9, 8), generator=g,
                          dtype=torch.int8)
    cases = {
        "lstm_recurrence": (r(2, 5, 3, 32), r(2, 32, 8),
                            torch.tensor([5, 1, 3], dtype=torch.int32)),
        "lstm_token_states": (r(2, 5, 3, 32), r(2, 32, 8),
                              torch.tensor([5, 1, 3], dtype=torch.int32)),
        "attention_pool": (r(2, 4, 4, 6), r(2, 4, 4, 2)),
        "vit_attention": (r(2, 5, 48, dtype=torch.bfloat16), 2),
        "conv_relu_pool_fused": (r(2, 9, 9, 16), r(8, 16, 3, 3), r(8)),
        "conv_relu_pool_stem": (r(2, 9, 9, 3, dtype=torch.bfloat16),
                                r(8, 3, 3, 3), r(8)),
        "fused_ln_mlp": (r(2, 5, 16), r(16), r(16), r(64, 16), r(64),
                         r(16, 64), r(16)),
        "conv_relu_pool_w8a8": (codes, 2.0, r(16, 8, 3, 3), r(16), 1, 5.0),
    }
    cases = {name: (name, args) for name, args in cases.items()}
    for mode in ("compute", "e4m3", "int8"):
        cases[f"relu_maxpool_{mode}"] = ("relu_maxpool", (
            r(2, 7, 6, 4, dtype=torch.bfloat16), r(4), mode, 3.0))
    return cases


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_opcheck_passes_for_every_vqa_op_on_the_cpu(case):
    """Schema, autograd registration, the fake implementation's shapes,
    dtypes and strides against the plain version's output, and the op
    under AOT dispatch with dynamic shapes."""
    name, args = _op_cases()[case]
    result = opcheck(getattr(torch.ops.vqa, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_op_module_of_the_loader_registers_its_ops():
    """The loader's op modules register the nine ops and no other."""
    import importlib

    for name in OP_MODULES:
        importlib.import_module(name)
    names = {n for n in dir(torch.ops.vqa) if not n.startswith("_")} - {
        "name"}
    assert names == {"lstm_recurrence", "lstm_token_states",
                     "relu_maxpool", "attention_pool",
                     "vit_attention", "conv_relu_pool_fused",
                     "conv_relu_pool_stem", "fused_ln_mlp",
                     "conv_relu_pool_w8a8"}


# -- the exported programs -------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_exported_graph_holds_the_live_path_s_ops(exported, name):
    """Each bucket's program: the vqa:: nodes the live forward dispatches,
    one a launch; no ATen op that only a plain version uses; no weight in
    its state dict, constants or example inputs, one input a weight."""
    predictor, path = exported(name)
    for bs in BUCKETS:
        program = torch.export.load(os.path.join(path, f"forward_b{bs}.pt2"))
        targets = collections.Counter(
            str(n.target) for n in program.graph.nodes
            if n.op == "call_function")
        vqa_nodes = {t.split(".")[1]: c for t, c in targets.items()
                     if t.startswith("vqa.")}
        assert vqa_nodes == CONFIGS[name][1]
        assert not (PLAIN_ONLY - VARIANT_ATEN.get(name, set())
                    ) & set(targets), targets
        assert not program.state_dict and not program.constants
        assert program.example_inputs is None  # the weights are stored once
        params = [n for n in program.graph.nodes
                  if n.op == "placeholder" and n.name.startswith("params_")]
        assert len(params) == len(predictor.model.state_dict())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_artifact_logits_equal_the_predictor_s(exported, name):
    """At a bucket's batch, the artifact's logits are the live
    ``Predictor.forward_logits``'s to the bit (f32 and bf16, every
    serving mode); numerics frozen in the metadata."""
    predictor, path = exported(name)
    artifact = load_artifact(path, device="cpu")
    images, questions, lengths = _inputs(4, seed=1)
    lengths = np.maximum(lengths, 1)
    np.testing.assert_array_equal(
        artifact.logits(images, questions, lengths),
        predictor.forward_logits(images, questions, lengths))
    meta = artifact.meta
    assert meta["compute_dtype"] == str(predictor.compute_dtype).split(".")[1]
    assert meta["fused_ops"] == predictor.fused_ops
    assert meta["store_dtype"] == predictor.model_cfg.image.store_dtype
    assert meta["quant_scales"] == list(
        predictor.model_cfg.image.quant_scales or ())


def test_port_artifact_matches_the_jax_artifact(tmp_path):
    """The same JAX weights (crossed over by ``utils/params.py``), f32:
    the port's artifact and the JAX package's, at every batch size, padded
    and split."""
    jax_cfg = _jax_cfg()
    params = vqa.init(jax.random.PRNGKey(5), jax_cfg)

    def forward(params, images, questions, lengths):
        return vqa.apply(params, jax_cfg, images, questions, lengths,
                         train=False, compute_dtype=jnp.float32)

    jax_aot.export_artifact(
        str(tmp_path / "jax"), params, forward, batch_sizes=BUCKETS,
        image_size=SIZE, max_question_length=L, vocab=_vocab())
    cfg = _cfg()
    model = load_jax_params(VqaNet(cfg, device="cpu"), jax.tree_util.tree_map(
        np.asarray, params))
    Predictor(cfg, model, _vocab(), device="cpu", max_question_length=L,
              compute_dtype=torch.float32).export_artifact(
        str(tmp_path / "port"), batch_sizes=BUCKETS)
    jax_side = jax_aot.load_artifact(str(tmp_path / "jax"))
    port = load_artifact(str(tmp_path / "port"), device="cpu")
    for n in (1, 2, 3, 4, 9):
        request = _inputs(n, seed=n)
        np.testing.assert_allclose(port.logits(*request),
                                   jax_side.logits(*request),
                                   atol=2e-5, rtol=1e-4)
    assert port.answers(*request) == jax_side.answers(*request)


# -- the artifact's contract -----------------------------------------------

def test_layout_and_metadata(exported):
    predictor, path = exported("cnn")
    assert sorted(os.listdir(path)) == ["forward_b2.pt2", "forward_b4.pt2",
                                        "meta.json", "params.npz"]
    with open(os.path.join(path, "meta.json")) as fd:
        meta = json.load(fd)
    assert meta["version"] == ARTIFACT_VERSION
    assert meta["batch_sizes"] == list(BUCKETS)
    assert (meta["image_size"], meta["max_question_length"]) == (SIZE, L)
    assert meta["central_fraction"] == predictor.central_fraction
    assert meta["device_type"] == "cpu"
    assert (meta["question_vocab"], meta["answer_vocab"]) == (
        _vocab()["question"], _vocab()["answer"])
    assert (meta["compute_dtype"], meta["fused_ops"], meta["store_dtype"]) \
        == ("bfloat16", False, "compute")
    with np.load(os.path.join(path, "params.npz")) as z:
        state = predictor.model.state_dict()
        assert sorted(z.files) == sorted(state)
        for key in z.files:
            assert z[key].dtype == np.float32
            np.testing.assert_array_equal(z[key], state[key].numpy())


def test_a_moe_artifact_gives_the_predictor_s_bits_at_buckets_1_8_64(
        tmp_path):
    """The ViT-MoE exported at the serving buckets 1, 8 and 64: the
    routing's shapes are static (the ``[E, G, C, D]`` buffer follows the
    bucket), so each bucket's program gives the live Predictor's logits
    on the same batch to the bit."""
    predictor = _predictor(encoder="vit", moe=4)
    path = str(tmp_path / "vit_moe")
    predictor.export_artifact(path, batch_sizes=(1, 8, 64))
    artifact = load_artifact(path, device="cpu")
    for n in (1, 8, 64):
        images, questions, lengths = _inputs(n, seed=n)
        lengths = np.maximum(lengths, 1)
        np.testing.assert_array_equal(
            artifact.logits(images, questions, lengths),
            predictor.forward_logits(images, questions, lengths))


def test_padding_and_splitting(exported):
    """1 and 3 pad up to a bucket, 9 splits into 4 + 4 + (1 padded to 2);
    lengths of 0 run as 1. Each block's rows are the live forward's of the
    same padded block, to the bit."""
    predictor, path = exported("cnn")
    artifact = load_artifact(path, device="cpu")
    for n, blocks in ((1, [(1, 2)]), (3, [(3, 4)]),
                      (9, [(4, 4), (4, 4), (1, 2)])):
        images, questions, lengths = _inputs(n, seed=n)
        assert (lengths == 0).any() or n == 1
        want, start = [], 0
        for take, bs in blocks:
            def pad(x):
                x = x[start:start + take]
                return np.concatenate(
                    [x, np.zeros((bs - take,) + x.shape[1:], x.dtype)])
            want.append(predictor.forward_logits(
                pad(images), pad(questions),
                np.maximum(pad(lengths), 1))[:take])
            start += take
        np.testing.assert_array_equal(
            artifact.logits(images, questions, lengths),
            np.concatenate(want))


def test_answer_decoding(exported):
    predictor, path = exported("cnn")
    artifact = load_artifact(path, device="cpu")
    images, questions, lengths = _inputs(4, seed=2)
    preds = predictor.forward_logits(images, questions,
                                     np.maximum(lengths, 1)).argmax(axis=1)
    assert artifact.answers(images, questions, lengths) == [
        f"ans{p}" for p in preds]  # 1-based answer ids


def test_loads_without_model_code(exported, tmp_path):
    """A process that loads the artifact and answers from it imports no
    module of the port's models, config, data, train, predict or serve,
    no jax, yaml or PIL; its logits are this process's."""
    _, path = exported("cnn_fused")
    expected = load_artifact(path, device="cpu").logits(*_inputs(3, seed=7))
    script = """
import sys
import numpy as np
from dl_vqa_tpu_torch.utils.aot_export import load_artifact
art = load_artifact(sys.argv[1], device="cpu")
r = np.random.default_rng(7)
logits = art.logits(
    r.standard_normal((3, %d, %d, 3)).astype(np.float32),
    r.integers(0, %d, (3, %d)).astype(np.int32),
    r.integers(0, %d, (3,)).astype(np.int32))
prefixes = ("dl_vqa_tpu_torch.models", "dl_vqa_tpu_torch.config",
            "dl_vqa_tpu_torch.data", "dl_vqa_tpu_torch.train",
            "dl_vqa_tpu_torch.predict", "dl_vqa_tpu_torch.serve",
            "dl_vqa_tpu", "jax", "yaml", "PIL")
forbidden = [m for m in sys.modules
             if any(m == p or m.startswith(p + ".") for p in prefixes)]
assert not forbidden, f"imported: {forbidden}"
np.save(sys.argv[2], logits)
""" % (SIZE, SIZE, TOKENS, L, L + 1)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out_file = str(tmp_path / "logits.npy")
    proc = subprocess.run([sys.executable, "-c", script, path, out_file],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(out_file), expected)


def test_another_device_is_refused_loudly(exported, tmp_path):
    """An artifact exported for CUDA is refused on the CPU, naming both;
    the loader's default device is the card, which a host without one
    refuses (with one, the CPU artifact is refused there)."""
    _, path = exported("cnn")
    alt = tmp_path / "cuda_artifact"
    shutil.copytree(path, alt)
    with open(alt / "meta.json") as fd:
        meta = json.load(fd)
    with open(alt / "meta.json", "w") as fd:
        json.dump(dict(meta, device_type="cuda"), fd)
    with pytest.raises(ValueError, match="exported for 'cuda'.*'cpu'"):
        load_artifact(str(alt), device="cpu")
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        load_artifact(path)


def test_an_uncalibrated_int8_predictor_is_not_exported(tmp_path):
    cfg = _cfg(store="int8")
    predictor = Predictor(cfg, VqaNet(cfg, device="cpu"), _vocab(),
                          device="cpu", max_question_length=L)
    assert predictor.needs_int8_calibration
    with pytest.raises(ValueError, match="calibrate_int8"):
        predictor.export_artifact(str(tmp_path / "a"), batch_sizes=(2,))
