"""Checkpoint packages: pickled nested dicts of NumPy arrays + configs.

Counterpart of openasr_tpu/utils/checkpoint.py (save / load, the
`ep-NNNN.pkg` listing, retention and averaging, :109-171); the file format
is the same, so model packages move between the two packages in both
directions (the weight layouts are translated by openasr_torch/convert.py).
Saves are synchronous.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
import re
from typing import List

import numpy as np

logger = logging.getLogger(__name__)

EPOCH_RE = re.compile(r"ep-(\d+)\.pkg$")


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


def epoch_checkpoints(exp_dir: str) -> List[str]:
    """`ep-NNNN.pkg` files sorted by epoch; other names are ignored."""
    numbered = [
        (int(m.group(1)), p)
        for p in glob.glob(os.path.join(exp_dir, "ep-*.pkg"))
        if (m := EPOCH_RE.search(p)) is not None
    ]
    return [p for _, p in sorted(numbered)]


def cleanup_ckpt(exp_dir: str, num_last_ckpt_keep: int) -> None:
    """Keep only the newest N epoch checkpoints."""
    paths = epoch_checkpoints(exp_dir)
    for p in paths[: max(0, len(paths) - num_last_ckpt_keep)]:
        try:
            os.remove(p)
        except FileNotFoundError:
            continue
        logger.info("Removed old checkpoint %s", p)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _is_float(x) -> bool:
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def average_packages(paths: List[str]) -> dict:
    """Average the model component states of several packages (in f64,
    written back as f32)."""
    if not paths:
        raise ValueError("No checkpoints to average")
    pkgs = [load_package(p) for p in paths]
    models = [pkg["model"] if "model" in pkg else pkg for pkg in pkgs]
    comps = [m["components"] for m in models]
    n = float(len(paths))
    avg = _tree_map(
        lambda *xs: (sum(np.asarray(x, np.float64) for x in xs) / n).astype(np.float32)
        if _is_float(xs[0]) else xs[0],
        *comps,
    )
    model = dict(models[0], components=avg)
    if "model" in pkgs[0]:
        return dict(pkgs[0], model=model)
    return model
