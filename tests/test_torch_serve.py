"""The port's serving daemon (``dl_vqa_tpu_torch/serve.py``) on the CPU.

The eight behaviours of ``tests/test_serve.py`` on the port, with that
file's tiny f32 config; the port's JPEG decoder against PIL (the JAX
``Predictor.preprocess_image``) on the JAX synthetic corpus's JPEGs and on
the committed fixtures; the served probabilities against the JAX
``Predictor.forward_probs`` on the same decoded pixels; 415 for a PNG.
Every client call has a timeout and every server is stopped at teardown.
"""

import base64
import dataclasses
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from dl_vqa_tpu.data import synthetic
from dl_vqa_tpu.data.dataset import VQADataset
from dl_vqa_tpu_torch.data.images import (
    IMAGENET_MEAN, IMAGENET_STD, UnsupportedImage, decode_image,
    load_image_files)
from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
    FIXTURES, LAYOUTS, load_expected, pil_transform)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = [
    "main.use_full=false",
    "train.max_answers=12",
    "train.image_size=32",
    "train.text.question_features=16",
    "train.text.embedding_features=8",
    "train.image.num_channels=[3, 4, 6]",
    "train.attention.hidden_dim=12",
    "train.classifier.hidden_dim=16",
    "tpu.compute_dtype=float32",
]


def _corpus(root, store_dtype="compute", extra=()):
    """A JAX synthetic corpus (JPEGs and h5 stores), a JAX checkpoint of
    the tiny model (saved in the compute mode; ``extra`` overrides name a
    variant of it) and the overrides that point both packages at them."""
    from dl_vqa_tpu import config as jax_config
    from dl_vqa_tpu.models import ModelConfig, vqa
    from dl_vqa_tpu.utils import checkpoint as ckpt

    profile = synthetic.make_synthetic_corpus(
        str(root / "data"), n_train=24, n_val=12, n_images=5, image_size=32,
        max_answers=12)
    overrides = OVERRIDES + [
        f"main.small.{group}.{key}={value}"
        for group, paths in profile.items() for key, value in paths.items()
    ] + [f"train.image.store_dtype={store_dtype}",
         f"main.small.paths.pretrained_model_path={root}/model.ckpt",
         *extra]
    cfg = jax_config.compose("config_eval", overrides=overrides)
    ds = VQADataset(data_paths=profile["val_paths"],
                    other_paths=profile["paths"])
    model_cfg = ModelConfig.from_cfg(cfg["train"], ds.num_tokens)
    model_cfg = dataclasses.replace(model_cfg, image=dataclasses.replace(
        model_cfg.image, store_dtype="compute"))
    params = vqa.init(jax.random.PRNGKey(0), model_cfg)
    ckpt.save_checkpoint(
        str(root / "model.ckpt"), params, model_cfg=model_cfg,
        extra_meta={"max_question_length": int(ds.max_question_length)})
    img_dir = os.path.join(profile["paths"]["base_path"], "val2014")
    jpegs = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))]
    return overrides, jpegs, img_dir


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import serve

    root = tmp_path_factory.mktemp("serve")
    overrides, jpegs, _ = _corpus(root)
    cfg = config_mod.compose("config_eval", overrides=overrides)
    httpd, service = serve.build_server(cfg, port=0, max_batch=8,
                                        batch_window_ms=30.0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    with open(jpegs[0], "rb") as fd:
        image_b64 = base64.b64encode(fd.read()).decode()
    try:
        yield base, image_b64, service, overrides, jpegs
    finally:
        service.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def _post(base, path, payload, timeout=30):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_healthz(server):
    base, _, _, _, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        payload = json.loads(resp.read())
    assert resp.status == 200 and payload["status"] == "ok"
    assert payload["backend"] == "cpu" and payload["device"] == "cpu"


def test_answer_endpoint(server):
    base, image_b64, _, _, _ = server
    status, payload = _post(base, "/v1/answer", {
        "image_b64": image_b64, "question": "what color is the cat?",
        "top_k": 3})
    assert status == 200
    answers = payload["answers"]
    assert len(answers) == 3
    assert all(isinstance(a, str) and 0.0 <= p <= 1.0 for a, p in answers)
    probs = [p for _, p in answers]
    assert sorted(probs, reverse=True) == probs


def test_concurrent_requests_coalesce(server):
    base, image_b64, service, _, _ = server
    before = service.metrics()
    results = [None] * 6

    def fire(i):
        results[i] = _post(base, "/v1/answer", {
            "image_b64": image_b64, "question": f"how many cats {i}?"})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(r is not None and r[0] == 200 for r in results)
    after = service.metrics()
    assert after["requests"] - before["requests"] == 6
    assert after["batches"] - before["batches"] < 6  # coalesced
    assert "latency_p50_ms" in after and "latency_p99_ms" in after


def test_bad_request_unknown_route_and_png(server):
    """400 without an image, 404 off the route; a PNG is answered (the
    exact decoder reads it as PIL does, the Predictor's pixels), a GIF
    gets 415 naming its format."""
    from PIL import Image

    base, _, service, _, _ = server
    status, payload = _post(base, "/v1/answer", {"question": "no image?"})
    assert status == 400 and "error" in payload
    status, _ = _post(base, "/nope", {})
    assert status == 404
    buf = io.BytesIO()
    Image.new("RGB", (40, 30), (200, 10, 10)).save(buf, "PNG")
    status, payload = _post(base, "/v1/answer", {
        "image_b64": base64.b64encode(buf.getvalue()).decode(),
        "question": "what color?", "top_k": 3})
    assert status == 200, payload
    predictor = service.predictor
    encoded, lengths = predictor.encode_questions(["what color?"])
    probs = predictor.forward_probs(
        predictor.preprocess_image(buf.getvalue())[None], encoded, lengths)
    want = predictor.top_k_from_probs(probs[0], 3)
    assert [a for a, _ in payload["answers"]] == [a for a, _ in want]
    buf = io.BytesIO()
    Image.new("RGB", (40, 30), (200, 10, 10)).save(buf, "GIF")
    status, payload = _post(base, "/v1/answer", {
        "image_b64": base64.b64encode(buf.getvalue()).decode(),
        "question": "what color?"})
    assert status == 415 and "a GIF" in payload["error"]


def test_bucket_clamps_to_max_batch_and_stop_terminates():
    from dl_vqa_tpu_torch import serve

    service = serve.BatchingService(predictor=None, max_batch=48,
                                    batch_window_ms=1.0)
    try:
        assert service._bucket(5) == 8
        assert service._bucket(33) == 48   # clamped, not 64
        assert service._bucket(48) == 48
    finally:
        service.stop()
    service.thread.join(timeout=2.0)
    assert not service.thread.is_alive()


def test_bounded_queue_backpressure():
    """A full queue raises ServiceOverloaded (503) and counts `rejected`;
    the accepted requests complete once the batcher drains."""
    from dl_vqa_tpu_torch import serve

    class _BlockingPredictor:
        max_question_length = 4

        def __init__(self):
            self.release = threading.Event()

        def encode_questions(self, qs):
            return (np.zeros((len(qs), 4), np.int32),
                    np.ones(len(qs), np.int32))

        def forward_probs(self, images, questions, lengths):
            self.release.wait(10.0)
            return np.full((len(images), 3), 1 / 3, np.float32)

        def top_k_from_probs(self, probs, k):
            return [["yes", 0.33]]

    pred = _BlockingPredictor()
    service = serve.BatchingService(pred, max_batch=1, batch_window_ms=0.0,
                                    max_queue=2)
    img = np.zeros((4, 4, 3), np.uint8)
    results, errors = [], []

    def fire():
        try:
            results.append(service.submit(img, "q", 1, timeout_s=15.0))
        except serve.ServiceOverloaded as exc:
            errors.append(exc)

    threads = [threading.Thread(target=fire) for _ in range(5)]
    try:
        # The first is taken by the batcher (and blocks in forward_probs);
        # then two fill the queue and the rest overflow it.
        for t in threads:
            t.start()
            time.sleep(0.15)
        assert len(errors) >= 1, "expected at least one overload rejection"
        pred.release.set()
        for t in threads:
            t.join(timeout=15.0)
        assert not any(t.is_alive() for t in threads)
        assert service.metrics()["rejected"] == len(errors)
        assert len(results) == 5 - len(errors)
    finally:
        pred.release.set()
        service.stop()


def test_warmup_runs_every_bucket():
    """warmup() runs every bucket ascending (a clamped non-power-of-two
    max included) on uint8 images, and counts warmed_buckets."""
    from dl_vqa_tpu_torch import serve

    calls = []

    class _CountingPredictor:
        image_size = 8
        max_question_length = 5

        def encode_questions(self, qs):
            return (np.zeros((len(qs), 5), np.int32),
                    np.ones(len(qs), np.int32))

        def forward_probs(self, images, questions, lengths):
            calls.append((images.shape, images.dtype))
            return np.full((len(images), 3), 1 / 3, np.float32)

        def top_k_from_probs(self, probs, k):
            return [["yes", 0.33]]

    service = serve.BatchingService(_CountingPredictor(), max_batch=48)
    try:
        assert service.metrics()["warmed_buckets"] == 0
        service.warmup(block=True)
    finally:
        service.stop()
    assert [c[0][0] for c in calls] == [1, 2, 4, 8, 16, 32, 48]
    assert all(c[0][1:] == (8, 8, 3) and c[1] == np.uint8 for c in calls)
    assert service.metrics()["warmed_buckets"] == 7


def test_int8_mode_requires_and_uses_calibration(tmp_path_factory):
    """train.image.store_dtype=int8: build_server refuses to start without
    --int8-calibration-dir, and refuses a directory with no JPEG, PNG or
    BMP (a GIF) by name; with the corpus's JPEGs it calibrates at startup
    and serves answers."""
    from PIL import Image

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import serve

    root = tmp_path_factory.mktemp("serve_int8")
    overrides, jpegs, img_dir = _corpus(root, store_dtype="int8")
    cfg = config_mod.compose("config_eval", overrides=overrides)
    with pytest.raises(SystemExit, match="int8-calibration-dir"):
        serve.build_server(cfg, port=0, device="cpu")
    gifs = root / "gifs"
    gifs.mkdir()
    Image.new("RGB", (32, 32)).save(gifs / "a.gif")
    with pytest.raises(SystemExit, match=r"no images \(\*\.jpg"):
        serve.build_server(cfg, port=0, device="cpu",
                           int8_calibration_dir=str(gifs))

    httpd, service = serve.build_server(
        cfg, port=0, max_batch=4, batch_window_ms=10.0, device="cpu",
        int8_calibration_dir=img_dir)
    assert len(service.predictor.model_cfg.image.quant_scales) == 2
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with open(jpegs[0], "rb") as fd:
            image_b64 = base64.b64encode(fd.read()).decode()
        status, body = _post(base, "/v1/answer", {
            "image_b64": image_b64, "question": "what color is the cat?",
            "top_k": 2})
        assert status == 200 and len(body["answers"]) == 2
    finally:
        service.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


# -- the decoder and the answers against the JAX package (PIL) -----------

def _jax_predictor(overrides):
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import predict as jax_predict
    from dl_vqa_tpu import config as jax_config

    cfg = jax_config.compose("config_eval", overrides=overrides)
    profile = cfg["main"]["small"]
    return jax_predict.Predictor(
        cfg, checkpoint_path=profile["paths"]["pretrained_model_path"],
        vocab_path=profile["paths"]["vocab_path"])


def test_decoder_matches_pil_on_the_corpus_and_the_fixtures(server):
    """libjpeg + the native resize against PIL: at most one uint8 level on
    the JAX corpus's JPEGs (the JAX Predictor's preprocess_image, in its
    normalized units) and on the fixtures, one by one and as files."""
    from PIL import Image

    from dl_vqa_tpu.data.images import preprocess_pil_image

    _, _, _, _, jpegs = server
    one_level = 1.0 / 255.0 / IMAGENET_STD.min() + 1e-6
    for path in jpegs:
        with open(path, "rb") as fd:
            mine = decode_image(fd.read(), 32, 0.875)
        with Image.open(path) as img:
            want = preprocess_pil_image(img, 32, 0.875).transpose(1, 2, 0)
        normed = (mine.astype(np.float32) / 255.0 - IMAGENET_MEAN) \
            / IMAGENET_STD
        assert np.abs(normed - want).max() <= one_level, path
    names = list(LAYOUTS)
    files = load_image_files([os.path.join(FIXTURES, f"{n}.jpg")
                              for n in names], 224, 0.875)
    expected = load_expected()
    for name, got in zip(names, files):
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as fd:
            np.testing.assert_array_equal(decode_image(fd.read(), 224, 0.875),
                                          got)
        assert np.abs(got.astype(int) - expected[name]).max() <= 1, name


def test_expected_npz_is_pils_transform_of_the_fixtures():
    expected = load_expected()
    assert sorted(expected) == sorted(LAYOUTS)
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 200 << 10
    for name, pixels in expected.items():
        assert pixels.shape == (224, 224, 3) and pixels.dtype == np.uint8
        np.testing.assert_array_equal(
            pil_transform(os.path.join(FIXTURES, f"{name}.jpg")), pixels)


def test_decoder_for_prefers_libjpeg_where_the_host_has_it(monkeypatch):
    """Every device serves with the exact decoder (PIL's pixels, the JAX
    package's default path); the builder's ``backend="auto"`` prefers
    libjpeg where the host builds it and has more than one core, as the
    JAX builder prefers its native library, else the exact decoder, which
    ``"pil"`` always takes."""
    from dl_vqa_tpu_torch.data import images

    assert images.decoder_for("cuda") == images.decoder_for("cpu") \
        == "exact"
    assert images.builder_decoder("auto") == "libjpeg"
    assert images.builder_decoder("native") == "libjpeg"
    assert images.builder_decoder("pil") == "exact"
    monkeypatch.setattr(images, "_libjpeg_buildable", lambda: False)
    assert images.builder_decoder("auto") == "exact"
    monkeypatch.setattr(images.os, "cpu_count", lambda: 1)
    monkeypatch.setattr(images, "_libjpeg_buildable", lambda: True)
    assert images.builder_decoder("auto") == "exact"


def test_decoder_refuses_what_it_cannot_decode(tmp_path):
    with pytest.raises(UnsupportedImage):
        decode_image(b"\x89PNG\r\n\x1a\n", 32, 0.875)
    with pytest.raises(ValueError, match="decode failed"):
        decode_image(b"\xff\xd8\xff", 32, 0.875)
    with pytest.raises(ValueError, match="central_fraction"):
        decode_image(b"\xff\xd8\xff", 32, 1.5)
    png = tmp_path / "a.jpg"
    png.write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(UnsupportedImage, match="a.jpg"):
        load_image_files([str(png)], 32, 0.875)
    with pytest.raises(FileNotFoundError, match="none.jpg"):
        load_image_files([str(tmp_path / "none.jpg")], 32, 0.875)


def test_served_probabilities_match_the_jax_predictor(server):
    """Every answer's probability as served (top_k = all 12 answers)
    against the JAX Predictor.forward_probs on the same decoded pixels, at
    the tolerance of test_npz_checkpoint_gives_the_jax_logits."""
    base, _, service, overrides, jpegs = server
    jax_side = _jax_predictor(overrides)
    questions = ["what color is the cat?", "how many dogs", "is it red?"]
    for path, question in zip(jpegs, questions):
        with open(path, "rb") as fd:
            raw = fd.read()
        status, payload = _post(base, "/v1/answer", {
            "image_b64": base64.b64encode(raw).decode(),
            "question": question, "top_k": 12})
        assert status == 200
        pixels = service.predictor.preprocess_image(raw)
        encoded, lengths = jax_side.encode_questions([question])
        want = jax_side.forward_probs(pixels[None], encoded, lengths)[0]
        ids = {a: i for i, a in jax_side.answer_by_id.items()}
        got = np.zeros_like(want)
        for answer, prob in payload["answers"]:
            got[ids[answer] - 1] = prob
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


# -- the nvJPEG decoder's host stages, against libjpeg on the CPU ----------

# libjpeg's planes after its inverse DCT (raw data out: Y, Cb, Cr at their
# subsampled sizes) and its RGB output at its defaults, for one JPEG; and C
# entries to the nvJPEG decoder's two host stages (csrc/host/ycc.h,
# resample.h), compiled with them.
_PLANES_CC = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include <jpeglib.h>

#include "resample.h"
#include "ycc.h"

extern "C" int ycc_to_rgb(const unsigned char* y, const unsigned char* cb,
                          const unsigned char* cr, int w, int h, int cw,
                          int ch, int h_expand, int v_expand,
                          unsigned char* rgb) {
  return vqa_torch::YccToRgb(y, cb, cr, w, h, cw, ch, h_expand, v_expand,
                             rgb) ? 0 : 1;
}

extern "C" int resample_crop(const unsigned char* rgb, int w, int h,
                             int image_size, double central_fraction,
                             unsigned char* out) {
  return vqa_torch::ResampleCrop(rgb, w, h, image_size, central_fraction,
                                 out) ? 0 : 1;
}

extern "C" int planes(const unsigned char* data, unsigned long len,
                      int* info, unsigned char* out) {
  jpeg_decompress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, data, len);
  jpeg_read_header(&c, TRUE);
  c.raw_data_out = TRUE;
  jpeg_start_decompress(&c);
  const int n = c.num_components;
  info[0] = c.image_width;
  info[1] = c.image_height;
  info[2] = n;
  std::vector<std::vector<unsigned char>> bufs(n);
  std::vector<std::vector<JSAMPROW>> rows(n);
  JSAMPARRAY arrays[4];
  std::vector<size_t> offset(n), done(n, 0);
  size_t at = 0;
  for (int ci = 0; ci < n; ++ci) {
    jpeg_component_info* comp = &c.comp_info[ci];
    const int bw = comp->width_in_blocks * DCTSIZE;
    const int rh = comp->v_samp_factor * DCTSIZE;
    bufs[ci].resize(size_t(bw) * rh);
    rows[ci].resize(rh);
    for (int r = 0; r < rh; ++r) rows[ci][r] = &bufs[ci][size_t(r) * bw];
    arrays[ci] = rows[ci].data();
    info[3 + 2 * ci] = comp->downsampled_width;
    info[4 + 2 * ci] = comp->downsampled_height;
    offset[ci] = at;
    at += size_t(comp->downsampled_width) * comp->downsampled_height;
  }
  while (c.output_scanline < c.output_height) {
    jpeg_read_raw_data(&c, arrays, c.max_v_samp_factor * DCTSIZE);
    for (int ci = 0; ci < n; ++ci) {
      jpeg_component_info* comp = &c.comp_info[ci];
      for (int r = 0; r < comp->v_samp_factor * DCTSIZE; ++r) {
        if (done[ci] >= size_t(comp->downsampled_height)) break;
        std::memcpy(out + offset[ci] + done[ci] * comp->downsampled_width,
                    rows[ci][r], comp->downsampled_width);
        ++done[ci];
      }
    }
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
  return n;
}

extern "C" void rgb(const unsigned char* data, unsigned long len,
                    unsigned char* out) {
  jpeg_decompress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, data, len);
  jpeg_read_header(&c, TRUE);
  c.out_color_space = JCS_RGB;
  jpeg_start_decompress(&c);
  while (c.output_scanline < c.output_height) {
    JSAMPROW row = out + size_t(c.output_scanline) * c.output_width * 3;
    jpeg_read_scanlines(&c, &row, 1);
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
}
"""


def _jpegs_of_every_layout():
    """The fixtures, and odd-sized JPEGs in each chroma layout PIL writes
    (hard colour edges everywhere), baseline and progressive."""
    from PIL import Image

    out = {}
    for name in LAYOUTS:
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as fd:
            out[name] = fd.read()
    rng = np.random.default_rng(3)
    for w, h in ((3, 5), (17, 9), (33, 34), (101, 57)):
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for sub in ("4:4:4", "4:2:2", "4:2:0"):
            for progressive in (False, True):
                buf = io.BytesIO()
                Image.fromarray(pixels).save(buf, "JPEG", quality=90,
                                             subsampling=sub,
                                             progressive=progressive)
                out[f"{w}x{h} {sub}{' p' if progressive else ''}"] = \
                    buf.getvalue()
    return out


def test_ycc_stage_gives_libjpegs_rgb(tmp_path):
    """The nvJPEG decoder's host stage (chroma upsampling and YCbCr -> RGB,
    csrc/host/ycc.cc) on libjpeg's own planes gives libjpeg's RGB to the
    bit, in every chroma layout, at odd sizes and at 1-2 sample wide
    chroma planes; then the resize copy on that RGB gives the native
    transform's pixels to the bit."""
    import ctypes
    import subprocess

    from dl_vqa_tpu_torch.ops import _host

    host = os.path.join(REPO, "dl_vqa_tpu_torch", "csrc", "host")
    so = str(tmp_path / "planes.so")
    src = tmp_path / "planes.cc"
    src.write_text(_PLANES_CC)
    subprocess.run(["g++", *_host.CXX_FLAGS, "-shared", f"-I{host}", "-o",
                    so, str(src), os.path.join(host, "ycc.cc"),
                    os.path.join(host, "resample.cc"), "-ljpeg"],
                   check=True, capture_output=True, timeout=120)
    harness = ctypes.CDLL(so)
    harness.ycc_to_rgb.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    harness.resample_crop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_double, ctypes.c_void_p]
    for name, raw in _jpegs_of_every_layout().items():
        info = np.zeros(9, np.int32)
        planes = np.zeros(3 * len(raw) * 64, np.uint8)
        n = harness.planes(raw, ctypes.c_ulong(len(raw)),
                           info.ctypes.data_as(ctypes.c_void_p),
                           planes.ctypes.data_as(ctypes.c_void_p))
        w, h = int(info[0]), int(info[1])
        want = np.zeros((h, w, 3), np.uint8)
        harness.rgb(raw, ctypes.c_ulong(len(raw)),
                    want.ctypes.data_as(ctypes.c_void_p))
        if n == 1:
            continue  # greyscale: widened on the host, nothing to upsample
        assert n == 3, name
        cw, ch = int(info[5]), int(info[6])
        cb = planes[w * h:]
        cr = planes[w * h + cw * ch:]
        got = np.zeros_like(want)
        code = harness.ycc_to_rgb(
            planes.ctypes.data, cb.ctypes.data, cr.ctypes.data, w, h, cw, ch,
            -(-w // cw), -(-h // ch), got.ctypes.data)
        assert code == 0, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        if min(w, h) >= 8:
            mine = np.zeros((8, 8, 3), np.uint8)
            assert harness.resample_crop(
                got.ctypes.data, w, h, 8, 0.875, mine.ctypes.data) == 0
            np.testing.assert_array_equal(mine, decode_image(raw, 8, 0.875),
                                          err_msg=name)
