"""Filesystem root of the port's on-disk state: the port's copy of
``predictionio_tpu/utils/fs.py``."""

from __future__ import annotations

import os


def fs_basedir() -> str:
    """The framework's on-disk root (``PIO_FS_BASEDIR``, default
    ``~/.predictionio_tpu``): persistent models live under it (reference
    ``PIO_FS_BASEDIR``, conf/pio-env.sh.template)."""
    return os.environ.get(
        "PIO_FS_BASEDIR", os.path.expanduser("~/.predictionio_tpu")
    )
