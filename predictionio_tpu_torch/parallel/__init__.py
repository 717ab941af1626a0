"""Device meshes for the port (the counterpart of
``predictionio_tpu/parallel``): one process drives every device of a
``Mesh``, whose shards may repeat a device. The multi-process half
(``distributed.py``) comes with ``pio train --coordinator``."""

from predictionio_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    check_data_axis,
    collapse_mesh,
    cut_rows,
    default_mesh,
    device_count,
    make_mesh,
    pad_to_multiple,
    shard_batch,
    split_rows,
    split_target,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "check_data_axis",
    "collapse_mesh",
    "cut_rows",
    "default_mesh",
    "device_count",
    "make_mesh",
    "pad_to_multiple",
    "shard_batch",
    "split_rows",
    "split_target",
]
