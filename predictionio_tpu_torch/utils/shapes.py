"""Shape bucketing helpers, copied from the reference so the batch size
``B`` and top-k width ``n`` the serving kernel sees match it exactly:
``pow2_at_least``/``pad_rows_pow2`` (``predictionio_tpu/ops/similarity.py``)
and ``pow2_topk_width`` (``predictionio_tpu/ops/retrieval.py``, without its
padding-waste metric)."""

from __future__ import annotations

import numpy as np


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Next power of two >= n (and >= floor): the serving bucketing rule."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def pad_rows_pow2(rows: np.ndarray, min_rows: int) -> np.ndarray:
    """Pad the leading axis with zero rows to the next power of two
    (>= min_rows), as float32."""
    rows = np.asarray(rows, np.float32)
    n = rows.shape[0]
    n_pad = pow2_at_least(n, min_rows)
    if n_pad == n:
        return rows
    return np.concatenate(
        [rows, np.zeros((n_pad - n, rows.shape[1]), np.float32)]
    )


def pow2_topk_width(max_num: int, n_items: int) -> int:
    """The top-k width for a batch whose largest query wants ``max_num``
    results: a power of two (min 16), clamped to the catalog, so it can be
    any value from 1 to ``n_items``."""
    return min(max(16, pow2_at_least(max_num)), n_items)
