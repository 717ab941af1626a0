"""Device resolution for the port (the single-GPU counterpart of
``predictionio_tpu/parallel/mesh.py``).

Every entry point takes an explicit ``device``. ``None`` means CUDA. The
CPU is used only when the caller asks for it (``device="cpu"``, as the
tests do); a missing CUDA device raises instead of quietly falling back.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: CUDA unless the caller
    names the CPU. Raises when CUDA is meant and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"unsupported device {device!r}: the port runs on 'cuda' or "
            "(when asked for explicitly) 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.index >= torch.cuda.device_count():
        raise ValueError(
            f"device {dev} does not exist ({torch.cuda.device_count()} "
            "CUDA devices present)"
        )
    return dev
