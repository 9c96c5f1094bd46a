"""Image constants, the image decoders, and the image store's builder.

``IMAGENET_MEAN``, ``IMAGENET_STD``, ``normalize_uint8_chw``,
``coco_id_from_filename`` and ``list_jpgs`` are the port's copies of
``dl_vqa_tpu/data/images.py``'s (held to them by
``tests/test_torch_copies.py``).

:func:`decode_image`, :func:`decode_image_files` and
:func:`load_image_files` give the reference transform of
``preprocess_pil_image`` up to the normalization: decode,
``convert("RGB")``, resize of the shorter edge to ``int(image_size /
central_fraction)`` by PIL's bilinear filter, centre crop, as uint8
``[S, S, 3]`` (the model normalises on the device). Three decoders, named
by the caller:

* ``"exact"``: PIL's pixels to the bit, without PIL, for JPEG, PNG and
  BMP. The host reads the file (a JPEG's entropy-coded coefficients in
  ``csrc/host/jpeg_entropy.cc``; a PNG's or BMP's RGB in
  :mod:`~dl_vqa_tpu_torch.data.image_formats`), then kernel E and
  ``color_resample`` (:mod:`dl_vqa_tpu_torch.ops.exact_decode`: libjpeg's
  inverse DCT, then its upsampling and colour conversion and PIL's resize
  at the crop) finish it on the card given by ``device_index`` (one call
  on a stream of its own), or their plain versions on the host where
  ``device_index`` is -1 (:func:`device_index_of` a CPU device). A list
  of files is read and entropy-decoded on Python threads (in C++, the
  interpreter lock released), and its device stages run a chunk of up to
  ``EXACT_CHUNK`` images a call while the threads read the next chunk.
  Needs only ``g++``;
* ``"libjpeg"``: ``csrc/host/image_decode.cc`` on the host (RGB,
  greyscale, and CMYK as PIL converts it), within one uint8 level of PIL
  (the native resize's float taps); a list of files runs on a pool of
  host threads in C++. JPEG only; needs libjpeg's headers;
* ``"nvjpeg"``: the card's nvJPEG, then libjpeg's chroma upsampling and
  colour conversion and the resize on the host
  (``csrc/host/nvjpeg_decode.cc``); its inverse DCT is not libjpeg's, so
  it is a few levels from PIL. One- and three-component JPEGs only (a
  CMYK file raises); a list of files runs on Python threads over its pool
  of decoder slots (ctypes releases the GIL during each call).

Other bytes raise :class:`UnsupportedImage`, naming the format.
:func:`decoder_for` names the decoder of every device: ``"exact"``, the
JAX package's PIL path. All refuse more pixels than PIL's
decompression-bomb threshold.

:func:`preprocess_images` is the image store's builder, the counterpart of
the JAX package's: every ``*.jpg`` of a COCO image directory decoded in
slabs, normalized, and written as fp16 ``features [N, 3, S, S]`` and int32
``ids [N]``, in an h5 file where h5py imports (the JAX package's layout, so
each package reads the other's store), else in an ``.npy`` directory. Its
``backend="pil"`` builds with ``"exact"``, the JAX builder's PIL loop to
the bit.
"""

import concurrent.futures
import functools
import os
import time
from typing import List, Sequence

import numpy as np

from dl_vqa_tpu_torch.data import image_formats
from dl_vqa_tpu_torch.data.image_formats import UnsupportedImage, sniff
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_uint8_chw",
           "coco_id_from_filename", "list_jpgs", "UnsupportedImage",
           "DECODERS", "EXACT_CHUNK", "EXACT_CHUNK_BYTES", "decoder_for",
           "decode_image", "decode_image_files", "load_image_files",
           "device_index_of", "builder_decoder", "preprocess_images"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

DECODERS = ("exact", "libjpeg", "nvjpeg")
# The exact decoder's images a device call in a list of files: a launch of
# color_resample and one copy each way a chunk. A chunk whose inputs pass
# EXACT_CHUNK_BYTES goes in several calls, so that a staging stays bounded
# for images far larger than COCO's (64 of them take 59 MB).
EXACT_CHUNK = 64
EXACT_CHUNK_BYTES = 64 << 20
_LIBRARY = {"libjpeg": "image", "nvjpeg": "nvjpeg"}  # each one's library


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
    """The decoder a model on ``device`` serves, evaluates and loads with:
    ``"exact"`` on every device, PIL's pixels as the JAX package's default
    paths give them (the Predictor, the HTTP front, the online loader)."""
    del device
    return "exact"


@functools.lru_cache(maxsize=None)
def _libjpeg_buildable() -> bool:
    from dl_vqa_tpu_torch.ops import _host

    return _host.missing("image") is None


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
        raise UnsupportedImage(f"{what} is not a JPEG: the {decoder} "
                               "decoder takes JPEG only")
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
    """Image bytes -> uint8 ``[image_size, image_size, 3]`` (RGB, resized
    and cropped). ``device_index``: the card nvJPEG or the exact decoder's
    kernels run on; -1 runs the exact decoder's plain versions on the
    host."""
    _check(image_size, central_fraction, decoder)
    return _decode(bytes(raw), image_size, central_fraction, decoder,
                   device_index, "the image")


def _decode(raw: bytes, image_size: int, central_fraction: float,
            decoder: str, device_index: int, what: str) -> np.ndarray:
    from dl_vqa_tpu_torch.ops import _host

    if decoder == "exact":
        source, plan = _exact_source(raw, image_size, central_fraction,
                                     what)
        try:
            return _exact_chunk([source], [plan], device_index)[0]
        finally:
            _close([source])
    if len(raw) < 3 or raw[0] != 0xFF or raw[1] != 0xD8:
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


def _exact_source(raw: bytes, image_size: int, central_fraction: float,
                  what: str) -> tuple:
    """The exact decoder's host stage of an image: ``(source, plan)``, its
    JPEG's coefficients (``image_formats.JpegData``) or its PNG's or BMP's
    RGB8, and its resize plan; raises naming ``what``."""
    from dl_vqa_tpu_torch.ops import exact_decode

    try:
        kind = sniff(raw)
    except UnsupportedImage as exc:
        raise UnsupportedImage(f"{what}: {exc}") from None
    source = (image_formats.read_jpeg(raw, what) if kind == "jpeg"
              else image_formats.read_rgb(raw, kind, what))
    try:
        return source, exact_decode.plan_of(source, image_size,
                                            central_fraction)
    except ValueError as exc:
        _close([source])
        raise ValueError(f"{what}: {exc}") from None


def _exact_chunk(sources, plans, device_index: int) -> np.ndarray:
    """The exact decoder's device stages of a chunk on card
    ``device_index``, or in the plain versions on the host where it is -1
    (:func:`dl_vqa_tpu_torch.ops.exact_decode.decode_batch`)."""
    import torch

    from dl_vqa_tpu_torch.ops import exact_decode

    device = (torch.device("cpu") if device_index < 0
              else torch.device("cuda", device_index))
    return exact_decode.decode_batch(sources, plans, device)


def _calls(done: list) -> List[list]:
    """A chunk's ``(source, plan)`` pairs in consecutive device calls of at
    most ``EXACT_CHUNK_BYTES`` of inputs (a JPEG's coefficients, a PNG's
    or BMP's RGB8), an image at least."""
    calls, size = [], EXACT_CHUNK_BYTES
    for source, plan in done:
        n = (sum(2 * 64 * bh * bw for bh, bw in source.shapes)
             if isinstance(source, image_formats.JpegData) else source.nbytes)
        if size + n > EXACT_CHUNK_BYTES:
            calls.append([])
            size = 0
        calls[-1].append((source, plan))
        size += n
    return calls


def _close(sources) -> None:
    for source in sources:
        if isinstance(source, image_formats.JpegData):
            source.close()


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
    """Image files -> uint8 ``[N, image_size, image_size, 3]`` in input
    order, decoded on ``num_threads`` threads (0: ``os.cpu_count()``):
    libjpeg's in a C++ pool; the exact decoder's read and entropy-decoded
    on Python threads (in C++, the GIL released), then its device stages a
    chunk of ``EXACT_CHUNK`` files a call while the threads read the next
    chunk; nvJPEG's as Python threads over its decoder slots. Raises for
    the first file in input order that fails, naming it; no file is
    replaced by anything else."""
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
    if decoder == "exact":
        _exact_files(paths, image_size, central_fraction, threads,
                     device_index, out)
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


def _exact_files(paths: List[str], image_size: int, central_fraction: float,
                 threads: int, device_index: int, out: np.ndarray) -> None:
    """The exact decoder over ``paths`` into ``out``: ``threads`` threads
    read and entropy-decode the files of chunk k + 1 while chunk k's
    device stages run (two chunks' sources held at a time); raises for the
    first file in input order that fails, after closing every source
    read."""
    chunks = [range(i, min(i + EXACT_CHUNK, len(paths)))
              for i in range(0, len(paths), EXACT_CHUNK)]

    def read(i: int) -> tuple:
        return _exact_source(_read(paths[i]), image_size, central_fraction,
                             paths[i])

    def settle(futures) -> list:
        """The futures' results in order; raises the first failure after
        closing every source that was read."""
        done, failure = [], None
        for future in futures:
            try:
                done.append(future.result())
            except Exception as exc:
                failure = failure or exc
        if failure is not None:
            _close(source for source, _ in done)
            raise failure
        return done

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        pending = [pool.submit(read, i) for i in chunks[0]]
        try:
            for k, chunk in enumerate(chunks):
                done = settle(pending)
                pending = ([pool.submit(read, i) for i in chunks[k + 1]]
                           if k + 1 < len(chunks) else [])
                try:
                    at = chunk.start
                    for call in _calls(done):
                        out[at:at + len(call)] = _exact_chunk(
                            [source for source, _ in call],
                            [plan for _, plan in call], device_index)
                        at += len(call)
                finally:
                    _close(source for source, _ in done)
        except BaseException:
            for future in pending:
                future.cancel()
            concurrent.futures.wait(pending)
            _close(future.result()[0] for future in pending
                   if not future.cancelled() and future.exception() is None)
            raise


def load_image_files(paths: Sequence[str], image_size: int,
                     central_fraction: float, decoder: str = "libjpeg",
                     device_index: int = 0) -> np.ndarray:
    """Image files -> uint8 ``[N, image_size, image_size, 3]``, one after
    another; raises on the first file that fails, naming it."""
    return decode_image_files(paths, image_size, central_fraction, decoder,
                              1, device_index)


def device_index_of(device) -> int:
    """The card index of a CUDA ``device`` (its current device where it
    names none); -1 for any other device (the exact decoder's plain
    versions on the host)."""
    if not str(device).startswith("cuda"):
        return -1
    import torch

    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def builder_decoder(backend: str) -> str:
    """The decoder :func:`preprocess_images` builds with: ``"pil"`` the
    exact decoder; ``"native"`` libjpeg (raising, naming what is missing,
    where it cannot be built); ``"auto"`` the JAX builder's rule, libjpeg
    where this host builds it and has more than one core, else the exact
    decoder."""
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown builder backend: {backend!r}")
    if backend == "native":
        from dl_vqa_tpu_torch.ops import _host

        reason = _host.missing("image")
        if reason is not None:
            raise RuntimeError(f"backend='native' needs libjpeg: {reason}")
        return "libjpeg"
    if (backend == "auto" and (os.cpu_count() or 1) > 1
            and _libjpeg_buildable()):
        return "libjpeg"
    return "exact"


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

    ``backend``: see :func:`builder_decoder` (``"pil"`` decodes with the
    exact decoder on ``device``, the JAX builder's PIL loop to the bit).
    ``num_threads=0`` means ``os.cpu_count()``."""
    decoder = builder_decoder(backend)
    device_index = device_index_of(device) if decoder == "exact" else -1
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
