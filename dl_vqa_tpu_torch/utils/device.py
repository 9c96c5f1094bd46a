"""The device an entry point runs on: the GPU unless the caller says so."""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "split_device_arg"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for
    (the default) and there is none. Nothing falls back to the CPU: a
    caller that wants it passes ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested (the default of "
            "dl_vqa_tpu_torch's entry points) but torch.cuda.is_available() "
            "is false; pass device=\"cpu\" to run on the CPU")
    return device


def split_device_arg(args):
    """``(device, the other arguments)`` of an entry point's command line,
    which may name its device with ``--device X`` (the GPU when it does
    not)."""
    args = list(args)
    if "--device" not in args:
        return DEFAULT_DEVICE, args
    at = args.index("--device")
    if at + 1 >= len(args):
        raise SystemExit("--device needs a device, e.g. --device cpu")
    device = args[at + 1]
    del args[at:at + 2]
    return device, args
