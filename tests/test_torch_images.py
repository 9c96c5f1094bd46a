"""The port's image store builder and batch decode
(``dl_vqa_tpu_torch.data.images``) against the JAX package's, on the CPU:
``preprocess_images`` against the JAX builder's native (libjpeg) and PIL
backends (the latter to the bit through the exact decoder), each package
reading the other's store, the ``.npy`` store where
h5py is missing, ``decode_image_files`` on threads, CMYK JPEGs against
PIL's conversion, and the files it refuses."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from dl_vqa_tpu.data import images as jax_images
from dl_vqa_tpu.data import native_loader
from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu.data.dataset import VQADataset as JaxDataset
from dl_vqa_tpu_torch.data import images as port_images
from dl_vqa_tpu_torch.data.dataset import VQADataset as PortDataset

SIZE = 64
FRACTION = 0.875
# One uint8 level in normalized units (the smallest std), and an fp16
# store's rounding of values up to |2.7|.
ONE_LEVEL = 1.0 / (255.0 * float(port_images.IMAGENET_STD.min()))
FP16_ROUNDING = 2.0 ** -9


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("images_corpus"))
    profile = jax_synthetic.make_synthetic_corpus(
        root, n_train=12, n_val=8, n_images=10, image_size=SIZE,
        max_answers=10)
    return profile


def _build(module, corpus, path, **kw):
    lines = []
    n = module.preprocess_images(
        other_paths=corpus["paths"], data_paths=corpus["train_paths"],
        image_size=SIZE, central_fraction=FRACTION, processed_path=path,
        log=lines.append, **kw)
    return n, lines


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as fd:
        return fd["features"][()], fd["ids"][()]


@pytest.fixture(scope="module")
def stores(corpus, tmp_path_factory):
    """The train split's store by the port (libjpeg, 3 threads, slabs of
    4) and by the JAX builder's native and PIL backends."""
    out = tmp_path_factory.mktemp("stores")
    port = str(out / "port.h5")
    n, lines = _build(port_images, corpus, port, backend="native",
                      batch_size=4, num_threads=3, device="cpu")
    jax_native = str(out / "jax_native.h5")
    _build(jax_images, corpus, jax_native, backend="native")
    jax_pil = str(out / "jax_pil.h5")
    _build(jax_images, corpus, jax_pil, backend="pil")
    return {"n": n, "lines": lines, "port": port, "jax_native": jax_native,
            "jax_pil": jax_pil}


def test_builder_equals_the_jax_native_builder_to_the_bit(stores):
    features, ids = _read_h5(stores["port"])
    want_features, want_ids = _read_h5(stores["jax_native"])
    assert stores["n"] == len(ids) == 10
    assert features.dtype == np.float16 and ids.dtype == np.int32
    assert features.shape == (10, 3, SIZE, SIZE)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(features, want_features)


def test_builder_is_within_002_of_the_jax_pil_builder(stores):
    """One uint8 level (1/(255 * 0.224) = 0.0175) plus fp16 rounding."""
    features, ids = _read_h5(stores["port"])
    want_features, want_ids = _read_h5(stores["jax_pil"])
    np.testing.assert_array_equal(ids, want_ids)
    err = np.abs(features.astype(np.float32)
                 - want_features.astype(np.float32)).max()
    assert err <= 0.02
    assert ONE_LEVEL + FP16_ROUNDING < 0.02


def test_builder_logs_the_decoder_and_the_container(stores):
    first = stores["lines"][0]
    assert first.startswith("Processing 10 images from ")
    assert "libjpeg, 3 threads" in first and "h5 file" in first
    assert any(line.startswith("Completed 0 images")
               for line in stores["lines"])


def test_the_h5_store_is_contiguous_and_uncompressed(stores):
    import h5py

    with h5py.File(stores["port"], "r") as fd:
        feats = fd["features"]
        assert feats.chunks is None and feats.compression is None
        assert feats.id.get_offset() is not None


@pytest.mark.parametrize("reader,writer", [("port", "jax_native"),
                                           ("jax", "port")])
def test_each_package_reads_the_others_store(corpus, stores, tmp_path,
                                             reader, writer):
    """A dataset of either package on the other's store: the same rows
    for the same image ids, and the images the store holds."""
    paths = dict(corpus["train_paths"], processed_imgs=stores[writer],
                 vqaDataset=str(tmp_path / "ds.npz"))
    cls = PortDataset if reader == "port" else JaxDataset
    ds = cls(data_paths=paths, other_paths=corpus["paths"])
    features, ids = _read_h5(stores[writer])
    np.testing.assert_array_equal(ids[ds.h5_rows], ds.image_ids)
    idx = np.arange(len(ds))
    np.testing.assert_array_equal(
        ds.load_images_chw(idx, np.float16), features[ds.h5_rows])


def test_without_h5py_the_npy_store_is_written_and_reads_back(
        corpus, stores, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = str(tmp_path / "store.h5")
    n, lines = _build(port_images, corpus, path, backend="auto",
                      batch_size=3, num_threads=2, device="cpu")
    assert os.path.isdir(path) and sorted(os.listdir(path)) == [
        "features.npy", "ids.npy"]
    assert ".npy directory" in lines[0]
    monkeypatch.undo()
    want_features, want_ids = _read_h5(stores["port"])
    np.testing.assert_array_equal(np.load(os.path.join(path, "ids.npy")),
                                  want_ids)
    np.testing.assert_array_equal(
        np.load(os.path.join(path, "features.npy")), want_features)
    paths = dict(corpus["train_paths"], processed_imgs=path)
    ds = PortDataset(data_paths=paths, other_paths=corpus["paths"])
    np.testing.assert_array_equal(
        ds.load_images_chw(np.arange(len(ds)), np.float16),
        want_features[ds.h5_rows])


def test_the_pil_backend_and_a_missing_libjpeg_raise(corpus, stores,
                                                     tmp_path, monkeypatch):
    """``backend="pil"`` builds with the exact decoder: the JAX builder's
    PIL store to the bit. An unknown backend raises; on a host with no
    libjpeg, ``"native"`` raises naming it and ``"auto"`` builds with the
    exact decoder, the same store."""
    from dl_vqa_tpu_torch.ops import _host

    path = str(tmp_path / "pil.h5")
    n, lines = _build(port_images, corpus, path, backend="pil",
                      batch_size=3, num_threads=2, device="cpu")
    assert n == stores["n"] and "(exact, 2 threads)" in lines[0]
    want_features, want_ids = _read_h5(stores["jax_pil"])
    features, ids = _read_h5(path)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(features, want_features)
    with pytest.raises(ValueError, match="unknown builder backend"):
        _build(port_images, corpus, str(tmp_path / "x.h5"), backend="turbo")
    monkeypatch.setattr(_host, "missing",
                        lambda name: "jpeglib.h not found: test")
    monkeypatch.setattr(port_images, "_libjpeg_buildable", lambda: False)
    native = str(tmp_path / "native.h5")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        _build(port_images, corpus, native, backend="native")
    assert not os.path.exists(native)
    auto = str(tmp_path / "auto.h5")
    _, lines = _build(port_images, corpus, auto, backend="auto",
                      device="cpu")
    assert "(exact," in lines[0]
    np.testing.assert_array_equal(_read_h5(auto)[0], want_features)


def test_a_failed_build_names_the_file_and_leaves_no_store(corpus,
                                                           tmp_path):
    image_dir = tmp_path / "imgs"
    image_dir.mkdir()
    src = os.path.join(corpus["paths"]["base_path"], "train2014")
    for name in sorted(os.listdir(src))[:3]:
        (image_dir / name).write_bytes(open(os.path.join(src, name),
                                            "rb").read())
    (image_dir / "COCO_train2014_000000000999.jpg").write_bytes(
        b"\xff\xd8\xff\xe0 truncated")
    path = str(tmp_path / "store.h5")
    with pytest.raises(ValueError, match="000000000999.jpg"):
        port_images.preprocess_images(
            other_paths={"base_path": str(tmp_path)},
            data_paths={"imgs": "imgs"}, image_size=SIZE,
            central_fraction=FRACTION, processed_path=path, log=lambda _: 0,
            backend="native", batch_size=2)
    assert os.listdir(tmp_path) == ["imgs"]


def _train_jpegs(corpus):
    image_dir = os.path.join(corpus["paths"]["base_path"], "train2014")
    return [os.path.join(image_dir, f)
            for f in sorted(port_images.list_jpgs(image_dir))]


def test_threads_give_the_bytes_of_one_and_of_the_native_library(corpus):
    paths = _train_jpegs(corpus)
    one = port_images.decode_image_files(paths, SIZE, FRACTION,
                                         num_threads=1)
    np.testing.assert_array_equal(
        port_images.decode_image_files(paths, SIZE, FRACTION, num_threads=4),
        one)
    np.testing.assert_array_equal(
        port_images.decode_image_files(paths, SIZE, FRACTION, num_threads=0),
        one)
    np.testing.assert_array_equal(
        port_images.load_image_files(paths, SIZE, FRACTION), one)
    np.testing.assert_array_equal(
        native_loader.process_paths(paths, SIZE, FRACTION, 2), one)
    assert port_images.decode_image_files([], SIZE, FRACTION).shape == (
        0, SIZE, SIZE, 3)


def _pil_transform(path, size, fraction):
    with Image.open(path) as img:
        img = jax_images._resize_shorter_edge(img.convert("RGB"),
                                              int(size / fraction))
        return np.asarray(jax_images._center_crop(img, size))


@pytest.mark.parametrize("size,fraction", [(SIZE, FRACTION), (90, 1.0)])
def test_a_cmyk_jpeg_decodes_as_pil_converts_it(tmp_path, size, fraction):
    """A CMYK JPEG (PIL writes it with its Adobe marker): within one level
    of PIL's transform after the resize, and PIL's ``convert("RGB")`` to
    the bit where nothing is resized (a crop of the full size)."""
    rng = np.random.default_rng(3)
    rgb = Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    path = str(tmp_path / "COCO_val2014_000000000007.jpg")
    rgb.resize((120, 90), Image.BILINEAR).convert("CMYK").save(path,
                                                               quality=90)
    with Image.open(path) as img:
        assert img.mode == "CMYK" and "adobe" in img.info
    got = port_images.decode_image_files([path, path], size, fraction,
                                         num_threads=2)
    want = _pil_transform(path, size, fraction)
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= (1 if fraction != 1.0 else 0)
    with open(path, "rb") as fd:
        np.testing.assert_array_equal(
            port_images.decode_image(fd.read(), size, fraction), got[0])


def test_the_files_it_refuses_raise_naming_the_file(corpus, tmp_path):
    good = _train_jpegs(corpus)[:3]
    png = tmp_path / "COCO_val2014_000000000005.jpg"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(png),
                                                        format="PNG")
    for threads in (1, 3):
        with pytest.raises(port_images.UnsupportedImage,
                           match="000000000005.jpg"):
            port_images.decode_image_files(good + [str(png)], SIZE,
                                           FRACTION, num_threads=threads)
        with pytest.raises(FileNotFoundError, match="missing.jpg"):
            port_images.decode_image_files(
                good + [str(tmp_path / "missing.jpg")], SIZE, FRACTION,
                num_threads=threads)
    with pytest.raises(ValueError, match="decoder must be"):
        port_images.decode_image_files(good, SIZE, FRACTION, decoder="pil")
