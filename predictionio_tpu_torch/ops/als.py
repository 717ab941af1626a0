"""ALS serving: the serving section of ``predictionio_tpu/ops/als.py``
(``ALSModelArrays`` :1233, ``ServingFactors`` :2402-2558,
``recommend_batch`` :2560, ``_unpack_indices`` :2575).

``ServingFactors`` uploads the factor matrices to its device once. Each
batch then pads its query rows to a power of two (min 8, the reference's
bucketing), launches K3 (``ops/topn.py``) and makes ONE device→host copy
of the packed ``[B, 2n]`` result. Training comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops.topn import topn_packed
from predictionio_tpu_torch.utils.shapes import pad_rows_pow2


def validate_solver(solver: str, block_size: int, rank: int) -> None:
    """The reference's solver-param coherence check
    (``predictionio_tpu/ops/als.py:133``), run when params are parsed."""
    if solver not in ("exact", "subspace"):
        raise ValueError(
            f"solver must be 'exact' or 'subspace', got {solver!r}"
        )
    if solver == "subspace":
        if not isinstance(block_size, int) or block_size <= 0:
            raise ValueError(
                "solver='subspace' requires block_size > 0 (a divisor of "
                f"rank={rank}); got block_size={block_size!r}"
            )
        if rank % block_size != 0:
            raise ValueError(
                f"block_size={block_size} must divide rank={rank} for "
                "the iALS++ blocked subspace solver"
            )


@dataclasses.dataclass
class ALSModelArrays:
    """Trained factors, host-resident numpy."""

    user_factors: np.ndarray  # [n_users, k]
    item_factors: np.ndarray  # [n_items, k]


class ServingFactors:
    """Device-resident factors for the serving hot path: the matrices go to
    ``device`` once; each request ships only its query rows up and one
    packed result buffer down."""

    def __init__(
        self,
        user_factors: np.ndarray,
        item_factors: np.ndarray,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.user_factors = np.asarray(user_factors)
        self._uf_dev = _upload(user_factors, self.device)
        self._if_dev = _upload(item_factors, self.device)
        self.n_items = self._if_dev.shape[0]

    def topn_by_rows(
        self, user_rows: np.ndarray, n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-N for explicit query factor rows [B, k]: (scores [B, n],
        item indices [B, n])."""
        b = len(user_rows)
        packed = self.topn_packed_device(user_rows, n).cpu().numpy()[:b]
        return packed[:, :n], _unpack_indices(packed, n)

    def topn_packed_device(self, user_rows: np.ndarray, n: int) -> torch.Tensor:
        """Upload the query rows padded to a power of two (min 8), run K3,
        and return the packed result still on the device. Callers slice
        the padding rows off."""
        q = _upload(pad_rows_pow2(user_rows, 8), self.device)
        return topn_packed(q, self._if_dev, n)

    def warm(self, n: int = 16, max_batch: int = 128) -> None:
        """Run every padded batch size the serving path can hit once at
        deploy, so the kernel is built and loaded before traffic."""
        k = self._uf_dev.shape[1]
        n = min(n, self.n_items)
        b = 8
        while True:
            self.topn_by_rows(np.zeros((b, k), np.float32), n)
            if b >= max_batch:
                break
            b *= 2

    def topn_by_user(self, user_ids: Sequence[int], n: int):
        """Top-N for known user indices (rows gathered on the host)."""
        rows = self.user_factors[np.asarray(user_ids, np.int64)]
        return self.topn_by_rows(rows, n)


def recommend_batch(
    query_factors: np.ndarray,
    item_factors: np.ndarray,
    n: int,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot top-N (uploads the factors on every call: use
    ServingFactors on the serving path). Returns (scores [B, n], item
    indices [B, n])."""
    dev = resolve_device(device)
    packed = topn_packed(
        _upload(query_factors, dev),
        _upload(item_factors, dev),
        n,
    ).cpu().numpy()
    return packed[:, :n], _unpack_indices(packed, n)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous float32 tensor on ``device`` (on the CPU it
    may share ``a``'s memory)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _unpack_indices(packed: np.ndarray, n: int) -> np.ndarray:
    """Recover int32 indices from their raw bits in the packed buffer."""
    return np.ascontiguousarray(packed[:, n:]).view(np.int32)
