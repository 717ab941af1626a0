"""Device meshes for serving and training: the counterpart of
``predictionio_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` once per workflow run and
places arrays on it with ``NamedSharding``; one process drives every device
(JAX is single-controller). The port keeps that model with its own small
``Mesh``: an ordered list of ``torch.device``s with named axes, driven by
this one process. It is not ``torch.distributed.DeviceMesh``, which needs a
process group and a process per device.

A mesh's shards are LOGICAL: one device may appear several times (``[cuda:0]
* 4`` serves four row shards from one card, one after another; the CPU
tests use ``["cpu"] * 8`` as the reference's tests use eight virtual CPU
devices). Answers are the same whatever devices the shards name. Axis
conventions are the reference's: ``data`` (``DATA_AXIS``) for batch and
row parallelism, ``model`` for tensor parallelism. Serving and ALS
training shard over a 1-D ``data`` mesh (``collapse_mesh``).

- ``make_mesh(axes, devices)``: named axes, e.g. ``{"data": 4}``; the
  product of the sizes must equal the device count (``ValueError``
  otherwise, as the reference raises). ``devices`` defaults to every
  visible CUDA device.
- ``default_mesh(axis_name, devices)``: a 1-D mesh over them.
- ``device_count()``: the visible CUDA devices.
- ``pad_to_multiple(n, multiple)`` and ``shard_batch(mesh, array, axis,
  batch_dim)``: the batch dimension zero-padded to a multiple of the axis
  size and cut into one tensor per shard, each on its shard's device;
  returns (the list, the original length).
- ``split_rows(weights, n_shards)``: contiguous row ranges of about equal
  weight, cut at row boundaries (training's row shards, balanced by each
  row's segment slots); ``cut_rows(mesh, array, bounds)``: those ranges of
  an array, each on its shard's device.

Multi-process meshes (``parallel/distributed.py``) come with the
multi-process launcher (``pio train --coordinator``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"  # batch and row parallelism: the axis serving and training shard over


class Mesh:
    """Named axes over an ordered list of devices (repeats allowed), in
    row-major order: with axes ``{"data": 2, "model": 2}`` device ``2·d + m``
    sits at ``(d, m)``."""

    def __init__(self, devices: Sequence[DeviceLike], axes: Dict[str, int]):
        sizes = [int(v) for v in axes.values()]
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axes {axes} must be positive")
        devs = [resolve_device(d) for d in devices]
        if math.prod(sizes) != len(devs):
            raise ValueError(
                f"mesh axes {axes} require {math.prod(sizes)} devices, have {len(devs)}"
            )
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.axis_names: Tuple[str, ...] = tuple(axes.keys())
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        """Devices (logical shards) in the mesh."""
        return len(self.devices)

    def shard_devices(self, axis: str = DATA_AXIS) -> List[torch.device]:
        """One device per index along ``axis``: the device at that index
        with every other axis at 0 (on a 1-D mesh, ``devices`` itself)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        grid = np.arange(self.size).reshape(list(self.shape.values()))
        pos = self.axis_names.index(axis)
        index = tuple(slice(None) if a == pos else 0 for a in range(grid.ndim))
        return [self.devices[int(i)] for i in grid[index]]

    def distinct_devices(self) -> List[torch.device]:
        """The devices the mesh names, each once, in first-seen order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def device_count() -> int:
    """Visible CUDA devices."""
    return torch.cuda.device_count()


def _visible_cuda() -> List[torch.device]:
    n = device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device is present; name the mesh's devices (e.g. "
            "['cpu'] * 4) to build one on the CPU explicitly"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh with named axes, e.g. ``{"data": 4}``. The product of the axis
    sizes must equal the device count. ``devices`` defaults to every
    visible CUDA device."""
    devs = list(devices) if devices is not None else _visible_cuda()
    return Mesh(devs, axes)


def default_mesh(axis_name: str = DATA_AXIS, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A 1-D mesh over all visible CUDA devices (or the given ones)."""
    devs = list(devices) if devices is not None else _visible_cuda()
    return make_mesh({axis_name: len(devs)}, devs)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def shard_batch(
    mesh: Mesh, array, axis: str = DATA_AXIS, batch_dim: int = 0
) -> Tuple[List[torch.Tensor], int]:
    """Pad the batch dimension with zeros to a multiple of the axis size and
    cut it into one contiguous tensor per shard, each on its shard's device
    (``Mesh.shard_devices``). Returns (the shards, the original length)."""
    arr = np.asarray(array)
    n = arr.shape[batch_dim]
    size = mesh.shape[axis]
    padded = pad_to_multiple(max(n, 1), size)
    if padded != n:
        pad_width = [(0, 0)] * arr.ndim
        pad_width[batch_dim] = (0, padded - n)
        arr = np.pad(arr, pad_width)
    per = padded // size
    out = []
    for s, dev in enumerate(mesh.shard_devices(axis)):
        part = np.take(arr, np.arange(s * per, (s + 1) * per), axis=batch_dim)
        out.append(torch.from_numpy(np.ascontiguousarray(part)).to(dev))
    return out, n


def split_rows(weights, n_shards: int) -> np.ndarray:
    """Boundaries [n_shards + 1] cutting rows 0..len(weights)-1 into
    ``n_shards`` contiguous ranges of about equal total weight: boundary j
    is the row boundary whose prefix weight lies nearest j/n_shards of the
    total (the lower one on a tie). They never decrease, so no row
    straddles two ranges, and a row heavier than a share leaves a range
    empty rather than being cut."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    w = np.asarray(weights, np.int64)
    if w.ndim != 1 or (w.size and w.min() < 0):
        raise ValueError("weights must be a 1-D array of non-negative counts")
    n = len(w)
    # compare cum·S with j·total: exact integer arithmetic
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(w, out=cum[1:])
    c = cum * n_shards
    t = np.arange(1, n_shards, dtype=np.int64) * cum[-1]
    hi = np.minimum(np.searchsorted(c, t, side="left"), n)
    lo = np.maximum(hi - 1, 0)
    cut = np.where(c[hi] - t < t - c[lo], hi, lo)
    return np.maximum.accumulate(np.concatenate([[0], cut, [n]])).astype(np.int64)


def cut_rows(mesh: Mesh, array, bounds) -> List[torch.Tensor]:
    """Rows ``bounds[s]:bounds[s + 1]`` of ``array`` as one contiguous
    tensor per shard of the ``DATA_AXIS``, each on its shard's device
    (``Mesh.shard_devices``); no padding, so a shard may get 0 rows."""
    arr = np.asarray(array)
    devs = mesh.shard_devices(DATA_AXIS)
    if len(bounds) != len(devs) + 1:
        raise ValueError(f"{len(bounds)} boundaries for {len(devs)} shards")
    return [torch.from_numpy(np.ascontiguousarray(arr[int(r0):int(r1)])).to(d)
            for d, r0, r1 in zip(devs, bounds[:-1], bounds[1:])]


def split_target(target) -> Tuple[Optional[Mesh], DeviceLike]:
    """(mesh, device) of what an algorithm trains or serves on: a ``Mesh``
    of several shards and None, or None and the device (one shard's mesh
    is its device; ``collapse_mesh`` checks the mesh)."""
    if isinstance(target, Mesh):
        return collapse_mesh(target, None)
    return None, target


def check_data_axis(axis: str) -> None:
    """The programs that take the reference's ``axis`` argument shard over
    ``DATA_AXIS`` only (``ValueError`` otherwise)."""
    if axis != DATA_AXIS:
        raise ValueError(f"the port shards over the {DATA_AXIS!r} axis, not {axis!r}")


def collapse_mesh(
    mesh: Optional[Mesh], device: DeviceLike
) -> Tuple[Optional[Mesh], DeviceLike]:
    """The (mesh, device) a serving structure or a training runs on. The
    mesh is a 1-D ``DATA_AXIS`` mesh (``ValueError`` otherwise); one of one shard
    collapses to the single-device path on that shard's device (unless
    ``device`` names one), as the reference collapses a 1-device mesh and
    keeps its device pin; anything but ``None`` or a ``Mesh`` raises
    ``TypeError``."""
    if mesh is None:
        return None, device
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a predictionio_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
    if mesh.axis_names != (DATA_AXIS,):
        raise ValueError(
            f"serving and training shard over a 1-D {DATA_AXIS!r} mesh, got axes {mesh.shape}"
        )
    if mesh.size == 1:
        return None, device if device is not None else mesh.devices[0]
    return mesh, None
