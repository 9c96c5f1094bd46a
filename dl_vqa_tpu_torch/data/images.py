"""Image constants, the normalization tail of the image cache, and the JPEG
decoder of the serving path.

``IMAGENET_MEAN``, ``IMAGENET_STD`` and ``normalize_uint8_chw`` are the
port's copy of ``dl_vqa_tpu/data/images.py``'s (held to them by
``tests/test_torch_copies.py``). The PIL cache builder
(``preprocess_images``) is not ported: the port's corpora are rendered by
:mod:`dl_vqa_tpu_torch.data.synthetic` straight into an ``.npy`` store.

:func:`decode_image` and :func:`load_image_files` give the reference
transform of ``preprocess_pil_image`` up to the normalization: decode,
resize of the shorter edge to ``int(image_size / central_fraction)`` by
PIL's bilinear filter, centre crop, as uint8 ``[S, S, 3]`` (the model
normalises on the device). They decode JPEG only; other bytes raise
:class:`UnsupportedImage`. Two decoders, named by the caller:

* ``"libjpeg"``: ``native/image_pipeline.cc`` on the host, within one
  uint8 level of PIL;
* ``"nvjpeg"``: the card's nvJPEG, then libjpeg's chroma upsampling and
  colour conversion and the resize on the host
  (``csrc/host/nvjpeg_decode.cc``), for hosts with no libjpeg; its inverse
  DCT is not libjpeg's, so it is a few levels from PIL.

:func:`decoder_for` names the one a device serves with: libjpeg wherever
the host can build it, so that every front of a host decodes alike and as
close to PIL as the port can. Both refuse more pixels than PIL's
decompression-bomb threshold.
"""

import functools
import os
from typing import Sequence

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_uint8_chw",
           "UnsupportedImage", "DECODERS", "decoder_for", "decode_image",
           "load_image_files"]

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
        raise ValueError(f"{what}: image decode failed (corrupt, truncated, "
                         "or more pixels than the decoder's cap)")
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


def load_image_files(paths: Sequence[str], image_size: int,
                     central_fraction: float, decoder: str = "libjpeg",
                     device_index: int = 0) -> np.ndarray:
    """JPEG files -> uint8 ``[N, image_size, image_size, 3]``, one after
    another; raises on the first file that fails, naming it."""
    _check(image_size, central_fraction, decoder)
    out = np.zeros((len(paths), image_size, image_size, 3), dtype=np.uint8)
    for i, path in enumerate(map(os.fspath, paths)):
        try:
            with open(path, "rb") as fd:
                raw = fd.read()
        except OSError as exc:
            raise FileNotFoundError(f"{path}: cannot be read") from exc
        out[i] = _decode(raw, image_size, central_fraction, decoder,
                         device_index, path)
    return out
