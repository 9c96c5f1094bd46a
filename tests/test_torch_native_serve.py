"""The port's native (C++) serving front on the CPU.

The thirteen behaviours of ``tests/test_native_serve.py`` on
``dl_vqa_tpu_torch/utils/native_front.py`` (``native/serve_front.cc``,
built by the port), with the answers held to the port's Python front
(``Predictor``'s forward on the port's libjpeg decoder's pixels, the same
tokenizer), plus the
order of tied probabilities. Every client call has a timeout; the shared
front is stopped at teardown.
"""

import base64
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.data.images import decode_image
from tests.test_torch_serve import _corpus


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """(base_url, image_b64, service, predictor, jpeg) on a live front."""
    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import serve
    from dl_vqa_tpu_torch.predict import Predictor

    root = tmp_path_factory.mktemp("native_serve")
    overrides, jpegs, _ = _corpus(root)
    cfg = config_mod.compose("config_eval", overrides=overrides)
    service = serve.build_native_server(cfg, port=0, max_batch=8,
                                        batch_window_ms=30.0, device="cpu")
    try:
        service.start_dispatch()
        service.warmup(block=True)
        predictor = Predictor.from_config(cfg, device="cpu")
        with open(jpegs[0], "rb") as fd:
            image_b64 = base64.b64encode(fd.read()).decode()
        yield (f"http://127.0.0.1:{service.port}", image_b64, service,
               predictor, jpegs[0])
    finally:
        service.stop()


def _post(base, path, payload, timeout=30):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_healthz_reports_native_front(stack):
    base = stack[0]
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        payload = json.loads(resp.read())
    assert resp.status == 200 and payload["status"] == "ok"
    assert payload["backend"] == "cpu"
    assert payload["front"] == "native"


def test_answer_matches_the_python_front(stack):
    """JSON -> base64 -> C++ decode (libjpeg, the port's libjpeg decoder's
    pixels to the bit) -> C++ tokenizer -> the uint8 forward -> top-k: the
    ranking and probabilities of the Python front's forward on those
    pixels."""
    base, image_b64, _, predictor, jpeg = stack
    for question in ("what color is it?", "how many cats are there"):
        status, payload = _post(base, "/v1/answer", {
            "image_b64": image_b64, "question": question, "top_k": 5})
        assert status == 200, payload
        with open(jpeg, "rb") as fd:
            image = decode_image(fd.read(), predictor.image_size,
                                 predictor.central_fraction, "libjpeg")
        encoded, lengths = predictor.encode_questions([question])
        probs = predictor.forward_probs(image[None], encoded, lengths)
        want = predictor.top_k_from_probs(probs[0], 5)
        got = payload["answers"]
        assert [a for a, _ in got] == [a for a, _ in want]
        np.testing.assert_allclose([p for _, p in got],
                                   [p for _, p in want], atol=1e-6)


def test_concurrent_requests_coalesce(stack):
    base, image_b64, service, _, _ = stack
    before = service.metrics()
    n = 12
    statuses = []
    lock = threading.Lock()

    def one():
        status, _ = _post(base, "/v1/answer", {
            "image_b64": image_b64, "question": "what is this?"})
        with lock:
            statuses.append(status)

    threads = [threading.Thread(target=one) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert statuses == [200] * n
    after = service.metrics()
    assert after["batched_requests"] - before["batched_requests"] == n
    assert after["batches"] - before["batches"] < n  # coalesced


def test_bad_requests(stack):
    base, image_b64, _, _, _ = stack
    assert _post(base, "/v1/answer",
                 {"question": 5, "image_b64": image_b64})[0] == 400
    assert _post(base, "/v1/answer", {"question": "hi?"})[0] == 400
    assert _post(base, "/v1/answer",
                 {"question": "hi?", "image_b64": "x"})[0] == 400
    # valid base64, not a JPEG -> 415, as on the Python front
    assert _post(base, "/v1/answer",
                 {"question": "hi?", "image_b64": "aGVsbG8="})[0] == 415
    assert _post(base, "/v1/answer",
                 {"question": "hi?",
                  "image_b64": base64.b64encode(b"\xff\xd8\xff").decode()}
                 )[0] == 400
    for top_k in (0, 999, 1e300):
        assert _post(base, "/v1/answer",
                     {"question": "hi?", "image_b64": image_b64,
                      "top_k": top_k})[0] == 400
    assert _post(base, "/v1/other", {"question": "hi?"})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert err.value.code == 404
    req = urllib.request.Request(
        base + "/v1/answer", data=b"{not json",
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400


def test_unicode_question_and_escapes(stack):
    base, image_b64, _, _, _ = stack
    status, payload = _post(base, "/v1/answer", {
        "image_b64": image_b64,
        "question": "what éléphant \"quoted\"\tis this?"})
    assert status == 200 and payload["answers"]


def test_tokenizer_matches_the_python_front(stack):
    _, _, service, predictor, _ = stack
    cases = [
        "what color is it?", "What Color IS it?", "no question mark", "",
        "a  b ?", "zzz unknownword here?", "trailing space ?", " leading?",
        "one two three four five six seven eight nine ten eleven twelve "
        "thirteen fourteen fifteen sixteen seventeen?",
    ]
    for q in cases:
        ids_c, n_c = service.tokenize(q)
        encoded, lengths = predictor.encode_questions([q])
        assert list(ids_c) == list(encoded[0]), q
        assert n_c == int(lengths[0]), q


def test_metrics_names_match_the_python_front(stack):
    base, _, service, _, _ = stack
    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        m = json.loads(resp.read())
    for key in ("requests", "batches", "batched_requests", "errors",
                "timeouts", "rejected", "mean_batch_size",
                "warmed_buckets"):
        assert key in m, key
    assert m["front"] == "native"
    assert m["warmed_buckets"] == 4  # buckets 1, 2, 4, 8
    assert m == service.metrics()


def test_decompression_bomb_rejected(stack):
    """A small JPEG whose SOF0 declares 65535 x 65535 is refused at the
    header (400), never allocated."""
    base, _, _, _, jpeg = stack
    with open(jpeg, "rb") as fd:
        data = bytearray(fd.read())
    sof = data.find(b"\xff\xc0")
    assert sof > 0, "fixture JPEG has no baseline SOF0 marker"
    data[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
    status, payload = _post(base, "/v1/answer", {
        "image_b64": base64.b64encode(bytes(data)).decode(),
        "question": "what is this?"})
    assert status == 400
    assert "decode failed" in payload["error"]


def test_vocab_is_write_once(stack):
    service = stack[2]
    with pytest.raises(RuntimeError, match="set_question_vocab"):
        service._upload_vocab()


def test_dispatch_error_maps_to_500(stack):
    base, image_b64, service, _, _ = stack
    good = service._fwd
    try:
        def boom(*_a, **_k):
            raise RuntimeError("injected dispatch failure")

        service._fwd = boom
        status, payload = _post(base, "/v1/answer", {
            "image_b64": image_b64, "question": "what is this?"})
        assert status == 500
        assert "injected dispatch failure" in payload["error"]
        assert service.metrics()["errors"] >= 1
    finally:
        service._fwd = good


def test_ties_go_to_the_lower_index(stack):
    """The forward ranks by a stable descending sort: equal probabilities
    come back lowest answer index first, as lax.top_k orders them."""
    service = stack[2]
    model = service.predictor.model

    class _Tied(torch.nn.Module):
        def forward(self, images, *_a, **_k):
            logits = torch.zeros(images.shape[0], 12)
            logits[:, 7] = 1.0
            return logits

    service.predictor.model = _Tied()
    try:
        packed = service._fwd(torch.zeros((2, 32, 32, 3), dtype=torch.uint8),
                              torch.zeros((2, 4), dtype=torch.int32),
                              torch.ones(2, dtype=torch.int32))
    finally:
        service.predictor.model = model
    k = service.topk_cap
    idx = packed[:, k:].contiguous().view(torch.int32)
    assert idx[0].tolist()[:5] == [7, 0, 1, 2, 3]
    probs = packed[0, :k]
    assert torch.all(probs[1:] == probs[1])


# Defined after the tests that use the shared front: these stop it and
# start fresh ones (the C++ side holds one front a process).
def test_backpressure_and_timeout(stack):
    from dl_vqa_tpu_torch.utils.native_front import NativeFrontService

    _, image_b64, service, predictor, _ = stack
    service.stop()
    # No dispatch loop: requests can only queue (then time out) or be
    # rejected once the 2-deep queue is full.
    svc = NativeFrontService(predictor, port=0, max_batch=2,
                             batch_window_ms=1.0, max_queue=2,
                             request_timeout_s=1.5)
    try:
        base2 = f"http://127.0.0.1:{svc.port}"
        statuses = []
        lock = threading.Lock()

        def one():
            status, _ = _post(base2, "/v1/answer", {
                "image_b64": image_b64, "question": "what is this?"})
            with lock:
                statuses.append(status)

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert statuses.count(504) == 2, statuses
        assert statuses.count(503) == 4, statuses
        m = svc.metrics()
        assert m["timeouts"] == 2 and m["rejected"] == 4, m
    finally:
        svc.stop()


def test_init_failure_stops_the_listener(stack, monkeypatch):
    """A constructor that fails after the listener started stops it on the
    way out, so a retry can start a front."""
    from dl_vqa_tpu_torch.utils.native_front import NativeFrontService

    _, _, service, predictor, _ = stack
    service.stop()  # one front a process; stopping again is a no-op
    monkeypatch.setattr(
        NativeFrontService, "_build_forward",
        lambda self: (_ for _ in ()).throw(RuntimeError("build boom")))
    with pytest.raises(RuntimeError, match="build boom"):
        NativeFrontService(predictor, port=0)
    monkeypatch.undo()
    svc = NativeFrontService(predictor, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/healthz", timeout=30) as resp:
            assert resp.status == 200
    finally:
        svc.stop()


def test_hostname_resolution(stack, monkeypatch):
    """--host localhost works as on the Python front; a name that does not
    resolve raises and says so (the resolver is stubbed: no lookup leaves
    the host)."""
    from dl_vqa_tpu_torch.utils.native_front import NativeFrontService

    _, _, service, predictor, _ = stack
    service.stop()  # one front a process; stopping again is a no-op
    svc = NativeFrontService(predictor, host="localhost", port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/healthz", timeout=30) as resp:
            assert resp.status == 200
    finally:
        svc.stop()

    def no_such_host(name):
        raise socket.gaierror(socket.EAI_NONAME, "Name or service not known")

    monkeypatch.setattr(socket, "gethostbyname", no_such_host)
    with pytest.raises(RuntimeError, match="cannot resolve host"):
        NativeFrontService(predictor, host="no.such.host.invalid", port=0)
