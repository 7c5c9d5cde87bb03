"""Training datasets and the loader.

The datasets are the JAX package's ``unopticalflow_tpu/data/datasets.py``,
a numpy-only module (cv2 is imported only where a PNG is read).  It is loaded
by its path, under a private module name, and not imported as
``unopticalflow_tpu.data.datasets``: that would first run
``unopticalflow_tpu/data/__init__.py``, which imports the JAX loader and so
``jax``.  Samples come back channels-last, (3H, W, 3), as the port's
training forward takes them.
"""

from __future__ import annotations

import importlib.util
import os
import sys

from unopticalflow_tpu_torch.data.loader import BatchLoader, device_prefetch

_DATASETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "unopticalflow_tpu", "data", "datasets.py",
)
_NAME = "unopticalflow_tpu_torch.data._datasets"


def _load_datasets():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _DATASETS)
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module
    spec.loader.exec_module(module)
    return module


_datasets = _load_datasets()
KITTI_Prepared = _datasets.KITTI_Prepared
SINTEL_Prepared = _datasets.SINTEL_Prepared

__all__ = ["BatchLoader", "KITTI_Prepared", "SINTEL_Prepared", "device_prefetch"]
