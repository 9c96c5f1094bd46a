"""Image constants, the JPEG decoders, and the image store's builder.

``IMAGENET_MEAN``, ``IMAGENET_STD``, ``normalize_uint8_chw``,
``coco_id_from_filename`` and ``list_jpgs`` are the port's copies of
``dl_vqa_tpu/data/images.py``'s (held to them by
``tests/test_torch_copies.py``).

:func:`decode_image`, :func:`decode_image_files` and
:func:`load_image_files` give the reference transform of
``preprocess_pil_image`` up to the normalization: decode, resize of the
shorter edge to ``int(image_size / central_fraction)`` by PIL's bilinear
filter, centre crop, as uint8 ``[S, S, 3]`` (the model normalises on the
device). They decode JPEG only; other bytes raise
:class:`UnsupportedImage`. Two decoders, named by the caller:

* ``"libjpeg"``: ``csrc/host/image_decode.cc`` on the host (RGB,
  greyscale, and CMYK as PIL converts it), within one uint8 level of PIL;
  a list of files runs on a pool of host threads in C++;
* ``"nvjpeg"``: the card's nvJPEG, then libjpeg's chroma upsampling and
  colour conversion and the resize on the host
  (``csrc/host/nvjpeg_decode.cc``), for hosts with no libjpeg; its inverse
  DCT is not libjpeg's, so it is a few levels from PIL. It takes one- and
  three-component JPEGs (a CMYK file raises); a list of files runs on
  Python threads over its pool of decoder slots (ctypes releases the GIL
  during each call).

:func:`decoder_for` names the one a device serves with: libjpeg wherever
the host can build it, so that every front of a host decodes alike and as
close to PIL as the port can. Both refuse more pixels than PIL's
decompression-bomb threshold.

:func:`preprocess_images` is the image store's builder, the counterpart of
the JAX package's: every ``*.jpg`` of a COCO image directory decoded in
slabs, normalized, and written as fp16 ``features [N, 3, S, S]`` and int32
``ids [N]``, in an h5 file where h5py imports (the JAX package's layout, so
each package reads the other's store), else in an ``.npy`` directory. The
JAX builder's PIL loop (``backend="pil"``) is not ported: the port does not
import PIL.
"""

import concurrent.futures
import functools
import os
import time
from typing import List, Sequence

import numpy as np

from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_uint8_chw",
           "coco_id_from_filename", "list_jpgs", "UnsupportedImage",
           "DECODERS", "decoder_for", "decode_image", "decode_image_files",
           "load_image_files", "preprocess_images"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

DECODERS = ("libjpeg", "nvjpeg")
_LIBRARY = {"libjpeg": "image", "nvjpeg": "nvjpeg"}  # each one's library


class UnsupportedImage(ValueError):
    """Bytes that are not a JPEG: the port decodes JPEG only (the serving
    fronts answer 415)."""


def normalize_uint8_chw(u8_nhwc: np.ndarray) -> np.ndarray:
    """uint8 ``[N, H, W, 3]`` (after resize and crop) -> float32
    normalized ``[N, 3, H, W]``."""
    arr = u8_nhwc.astype(np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(arr.transpose(0, 3, 1, 2))


def coco_id_from_filename(filename: str) -> int:
    """COCO id from e.g. ``COCO_train2014_000000000123.jpg`` -> 123
    (ref ``preprocess_images.py:47-48``)."""
    return int(filename.split("_")[-1].split(".")[0])


def list_jpgs(image_dir: str) -> List[str]:
    return [f for f in os.listdir(image_dir) if f.endswith(".jpg")]


def decoder_for(device) -> str:
    """The decoder a model on ``device`` serves with: libjpeg where this
    host has its compiler and headers (the native front's decoder too);
    else nvJPEG on a CUDA device. On the CPU with no libjpeg it is still
    libjpeg, whose build then raises and names what is missing."""
    if str(device).startswith("cuda") and not _libjpeg_buildable():
        return "nvjpeg"
    return "libjpeg"


@functools.lru_cache(maxsize=None)
def _libjpeg_buildable() -> bool:
    from dl_vqa_tpu_torch.ops import _host

    return _host.missing("image") is None


def _is_jpeg(raw: bytes) -> bool:
    """The JPEG start-of-image marker, as the native front tests it."""
    return len(raw) >= 3 and raw[0] == 0xFF and raw[1] == 0xD8


def _check(image_size: int, central_fraction: float, decoder: str) -> None:
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got "
                         f"{decoder!r}")
    if image_size < 1 or not 0.0 < central_fraction <= 1.0:
        raise ValueError(f"image_size {image_size} and central_fraction "
                         f"{central_fraction}: need image_size >= 1 and "
                         "0 < central_fraction <= 1")


def _raise_for(code: int, what: str, decoder: str) -> None:
    if code == 0:
        return
    if code == 2:
        raise UnsupportedImage(f"{what} is not a JPEG: dl_vqa_tpu_torch "
                               "decodes JPEG only")
    if code == 1:
        layouts = ("one or three components" if decoder == "nvjpeg"
                   else "greyscale, RGB or CMYK")
        raise ValueError(f"{what}: image decode failed (corrupt, truncated, "
                         f"a layout the {decoder} decoder does not take: it "
                         f"takes {layouts}; or more pixels than the "
                         "decoder's cap)")
    if code == 3:
        raise FileNotFoundError(f"{what}: cannot be read")
    from dl_vqa_tpu_torch.ops import _host

    detail = _host.library("nvjpeg").vqa_torch_nvjpeg_last_error().decode()
    raise RuntimeError(f"{what}: {decoder} decoder error: {detail}")


def decode_image(raw: bytes, image_size: int, central_fraction: float,
                 decoder: str = "libjpeg", device_index: int = 0
                 ) -> np.ndarray:
    """JPEG bytes -> uint8 ``[image_size, image_size, 3]`` (RGB, resized
    and cropped). ``device_index``: the card nvJPEG decodes on."""
    _check(image_size, central_fraction, decoder)
    return _decode(bytes(raw), image_size, central_fraction, decoder,
                   device_index, "the image")


def _decode(raw: bytes, image_size: int, central_fraction: float,
            decoder: str, device_index: int, what: str) -> np.ndarray:
    from dl_vqa_tpu_torch.ops import _host

    if not _is_jpeg(raw):
        _raise_for(2, what, decoder)
    out = np.empty((image_size, image_size, 3), dtype=np.uint8)
    lib = _host.library(_LIBRARY[decoder])
    if decoder == "libjpeg":
        code = lib.vqa_torch_decode_jpeg(
            raw, len(raw), image_size, central_fraction, out.ctypes.data)
    else:
        code = lib.vqa_torch_nvjpeg_decode(
            raw, len(raw), image_size, central_fraction, device_index,
            out.ctypes.data)
    _raise_for(code, what, decoder)
    return out


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as fd:
            return fd.read()
    except OSError as exc:
        raise FileNotFoundError(f"{path}: cannot be read") from exc


def decode_image_files(paths: Sequence[str], image_size: int,
                       central_fraction: float, decoder: str = "libjpeg",
                       num_threads: int = 1, device_index: int = 0
                       ) -> np.ndarray:
    """JPEG files -> uint8 ``[N, image_size, image_size, 3]`` in input
    order, decoded on ``num_threads`` threads (0: ``os.cpu_count()``):
    libjpeg's in a C++ pool, nvJPEG's as Python threads over its decoder
    slots. Raises for the first file in input order that fails, naming
    it; no file is replaced by anything else."""
    _check(image_size, central_fraction, decoder)
    paths = [os.fspath(p) for p in paths]
    threads = max(1, min(num_threads or (os.cpu_count() or 1),
                         max(len(paths), 1)))
    out = np.empty((len(paths), image_size, image_size, 3), dtype=np.uint8)
    if not paths:
        return out
    if decoder == "libjpeg":
        import ctypes

        from dl_vqa_tpu_torch.ops import _host

        status = np.zeros(len(paths), dtype=np.uint8)
        names = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
        failures = _host.library("image").vqa_torch_decode_files(
            ctypes.cast(names, ctypes.c_void_p), len(paths), image_size,
            central_fraction, out.ctypes.data, threads, status.ctypes.data)
        if failures:
            first = int(np.flatnonzero(status)[0])
            _raise_for(int(status[first]), paths[first], decoder)
        return out

    def one(i: int) -> None:
        out[i] = _decode(_read(paths[i]), image_size, central_fraction,
                         decoder, device_index, paths[i])

    if threads == 1:
        for i in range(len(paths)):
            one(i)
        return out
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        # list() raises the first failure in input order.
        list(pool.map(one, range(len(paths))))
    return out


def load_image_files(paths: Sequence[str], image_size: int,
                     central_fraction: float, decoder: str = "libjpeg",
                     device_index: int = 0) -> np.ndarray:
    """JPEG files -> uint8 ``[N, image_size, image_size, 3]``, one after
    another; raises on the first file that fails, naming it."""
    return decode_image_files(paths, image_size, central_fraction, decoder,
                              1, device_index)


def device_index_of(device) -> int:
    """The card index of a CUDA ``device`` (its current device where it
    names none); 0 for any other device."""
    if not str(device).startswith("cuda"):
        return 0
    import torch

    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


class _StoreWriter:
    """A new image store's two arrays at a temporary path beside
    ``processed_path``: an h5 file where h5py imports, else an ``.npy``
    directory. :meth:`commit` closes them and moves the store into place;
    :meth:`discard` removes it."""

    def __init__(self, processed_path: str, n: int, image_size: int):
        self.path = processed_path
        self.tmp = f"{processed_path}.tmp{os.getpid()}"
        shape = (n, 3, image_size, image_size)
        try:
            import h5py
        except ImportError:
            h5py = None
        if h5py is not None:
            self.container = "h5 file"
            self._h5 = h5py.File(self.tmp, "w", libver="latest")
            self.features = self._h5.create_dataset(
                "features", shape=shape, dtype="float16")
            self.ids = self._h5.create_dataset("ids", shape=(n,),
                                               dtype="int32")
            return
        self.container = ".npy directory"
        self._h5 = None
        os.makedirs(self.tmp)
        self.features = np.lib.format.open_memmap(
            os.path.join(self.tmp, "features.npy"), mode="w+",
            dtype=np.float16, shape=shape)
        self.ids = np.lib.format.open_memmap(
            os.path.join(self.tmp, "ids.npy"), mode="w+", dtype=np.int32,
            shape=(n,))

    def _close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
        else:
            self.features.flush()
            self.ids.flush()
        self.features = self.ids = None

    def commit(self) -> None:
        self._close()
        os.replace(self.tmp, self.path)

    def discard(self) -> None:
        import shutil

        self._close()
        if os.path.isdir(self.tmp):
            shutil.rmtree(self.tmp)
        elif os.path.exists(self.tmp):
            os.remove(self.tmp)


def preprocess_images(
    other_paths: dict,
    data_paths: dict,
    image_size: int,
    central_fraction: float,
    processed_path: str,
    log=print,
    backend: str = "auto",
    batch_size: int = 256,
    num_threads: int = 0,
    device=DEFAULT_DEVICE,
) -> int:
    """Scan a COCO image directory (``base_path / imgs``) and write the
    processed image store at ``processed_path``; returns the number of
    images written.

    The store holds fp16 ``features [N, 3, S, S]`` (normalized) and int32
    ``ids [N]`` (the COCO id of each file name), in :func:`list_jpgs`
    order, written ``batch_size`` images at a time: an h5 file (``"w"``,
    ``libver="latest"``, contiguous and uncompressed, as the JAX builder
    writes it) where h5py imports, else a directory holding
    ``features.npy`` and ``ids.npy``. It is written under a temporary name
    and renamed into place when whole.

    ``backend``: ``"auto"`` decodes with :func:`decoder_for` ``(device)``;
    ``"native"`` with libjpeg (raising, naming what is missing, where it
    cannot be built); ``"pil"`` raises (the JAX package's PIL loop: the
    port does not import PIL, ROADMAP queue 3). ``num_threads=0`` means
    ``os.cpu_count()``."""
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown builder backend: {backend!r}")
    if backend == "pil":
        raise NotImplementedError(
            "backend='pil' is the JAX package's PIL loop; dl_vqa_tpu_torch "
            "does not import PIL (ROADMAP queue 3, JPEG only): use 'auto' "
            "or 'native'")
    if backend == "native":
        from dl_vqa_tpu_torch.ops import _host

        reason = _host.missing("image")
        if reason is not None:
            raise RuntimeError(f"backend='native' needs libjpeg: {reason}")
        decoder = "libjpeg"
    else:
        decoder = decoder_for(device)
    device_index = device_index_of(device) if decoder == "nvjpeg" else 0
    image_dir = os.path.join(other_paths["base_path"], data_paths["imgs"])
    filenames = list_jpgs(image_dir)
    n = len(filenames)
    if n == 0:
        raise FileNotFoundError(f"no *.jpg in {image_dir!r} to build the "
                                f"image store {processed_path!r} from")
    threads = num_threads or (os.cpu_count() or 1)
    store = _StoreWriter(processed_path, n, image_size)
    log(f"Processing {n} images from {image_dir} ({decoder}, {threads} "
        f"threads) into an {store.container} at {processed_path}")
    t0 = time.perf_counter()
    try:
        for i0 in range(0, n, batch_size):
            slab = filenames[i0:i0 + batch_size]
            u8 = decode_image_files(
                [os.path.join(image_dir, f) for f in slab], image_size,
                central_fraction, decoder, threads, device_index)
            store.features[i0:i0 + len(slab)] = normalize_uint8_chw(
                u8).astype(np.float16)
            store.ids[i0:i0 + len(slab)] = [coco_id_from_filename(f)
                                            for f in slab]
            if (i0 // batch_size) % 4 == 0:
                log(f"Completed {i0} images")
    except BaseException:
        store.discard()
        raise
    store.commit()
    seconds = time.perf_counter() - t0
    log(f"Wrote {n} images in {seconds:.1f} s "
        f"({n / max(seconds, 1e-9):.1f} images/s)")
    return n
