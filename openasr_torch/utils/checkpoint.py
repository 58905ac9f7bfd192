"""Checkpoint packages: pickled nested dicts of NumPy arrays + configs.

Counterpart of `save_package` / `load_package` in
openasr_tpu/utils/checkpoint.py; the file format is the same, so packages
move between the two packages in both directions (the weight layouts are
translated by openasr_torch/convert.py).
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np

logger = logging.getLogger(__name__)


def to_numpy_tree(tree):
    """Tensors/arrays -> host NumPy; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "shape"):
        return np.asarray(tree)
    return tree


def save_package(pkg: dict, path: str) -> None:
    """tmp-write + fsync + atomic rename, so a crash never leaves a
    truncated package behind."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_numpy_tree(pkg), f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    logger.info("Saved checkpoint %s", path)


def load_package(path: str) -> dict:
    """Unpickle a package.  Only load packages this project wrote:
    unpickling can run arbitrary code."""
    with open(path, "rb") as f:
        return pickle.load(f)
