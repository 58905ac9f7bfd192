"""Checkpoint packages: pickled nested dicts of NumPy arrays + configs.

Counterpart of openasr_tpu/utils/checkpoint.py (save / load, the
asynchronous writer, the `ep-NNNN.pkg` listing, retention, averaging and
`average_last_ckpts`);
the file format is the same, so packages move between the two packages in
both directions (the weight and optimizer-state layouts are translated by
openasr_torch/convert.py).

`load_package` reads a package the JAX package wrote without importing
jax: its optimizer state pickles as the JAX package's and optax's state
classes, which unpickle into the port's NamedTuples of the same fields,
and its bfloat16 moments (NumPy arrays of ml_dtypes' bfloat16) into f32.
"""

from __future__ import annotations

import atexit
import glob
import logging
import os
import pickle
import re
import threading
from typing import List

import numpy as np

from openasr_torch.ops import optimizers
from openasr_torch.ops.fused_adam import FusedClipAdamState

logger = logging.getLogger(__name__)

# the state classes of the JAX package's optimizers, by the module paths
# they pickle under (optax 0.2), and the port's classes of the same fields
STATE_CLASSES = {
    ("openasr_tpu.ops.fused_adam", "FusedClipAdamState"): FusedClipAdamState,
    ("optax._src.transform", "ScaleByAdamState"): optimizers.ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): optimizers.ScaleByScheduleState,
    ("optax.transforms._accumulation", "TraceState"): optimizers.TraceState,
    ("optax._src.base", "EmptyState"): optimizers.EmptyState,
    ("optax.transforms._conditionality", "ApplyIfFiniteState"): optimizers.ApplyIfFiniteState,
    ("optax.transforms._masking", "MaskedState"): optimizers.MaskedState,
    ("optax.transforms._masking", "MaskedNode"): optimizers.MaskedNode,
}
# what a package's arrays and configs need besides those
NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
}
BUILTINS = {"set", "frozenset", "complex", "slice", "bytearray", "range"}


class _Bfloat16:
    """Stands for ml_dtypes' bfloat16 scalar type while unpickling."""


class PackageUnpickler(pickle.Unpickler):
    """Unpickles packages of either package: NumPy's reconstructors,
    harmless builtins and the optimizer-state classes above, mapped to the
    port's.  A bfloat16 dtype becomes a fresh 2-byte void dtype, whose
    arrays `load_package` widens to f32; any other global raises, naming
    it."""

    def __init__(self, f):
        super().__init__(f)
        self.bf16_dtypes: List[np.dtype] = []

    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in STATE_CLASSES:
            return STATE_CLASSES[key]
        if key == ("numpy", "dtype"):
            return self._dtype
        if key == ("ml_dtypes", "bfloat16"):
            return _Bfloat16
        if key in NUMPY_GLOBALS or (module == "builtins" and name in BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"package holds {module}.{name}, which the port does not read "
            "(it reads NumPy arrays, builtins and the optimizer states of "
            "openasr_tpu.ops.fused_adam and optax)"
        )

    def _dtype(self, obj, align=False, copy=False):
        if obj is _Bfloat16:
            # np.dtype("V2") is a new object each call, so the state that
            # pickle sets on it next changes no dtype NumPy shares
            dtype = np.dtype("V2")
            self.bf16_dtypes.append(dtype)
            return dtype
        return np.dtype(obj, align, copy)


def _widen_bf16(tree, bf16_dtypes):
    """Arrays of the bfloat16 stand-in dtypes -> f32 (exact); containers
    (dicts, lists, tuples, NamedTuples) rebuilt around them."""
    if isinstance(tree, np.ndarray):
        if any(tree.dtype is d for d in bf16_dtypes):
            bits = tree.view(np.uint16).astype(np.uint32) << 16
            return bits.view(np.float32)
        return tree
    if isinstance(tree, dict):
        return {k: _widen_bf16(v, bf16_dtypes) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_widen_bf16(v, bf16_dtypes) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_widen_bf16(v, bf16_dtypes) for v in tree)
    return tree

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
    _write_package(to_numpy_tree(pkg), path)


def _write_package(host_pkg: dict, path: str) -> None:
    """tmp-write + fsync + atomic rename, so a crash never leaves a
    truncated package behind."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host_pkg, f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    logger.info("Saved checkpoint %s", path)


class AsyncCheckpointer:
    """Writes packages on a background thread.  `save` takes the host
    snapshot on the caller (so later steps cannot change what is written)
    and hands the pickle + fsync + rename to a daemon thread; writes are
    serialised (a save waits for the one before).  `wait()` joins the
    writer and re-raises its failure; pending writes drain at exit."""

    def __init__(self):
        self._thread = None
        self._error = None
        atexit.register(self._drain_at_exit)

    def save(self, pkg: dict, path: str) -> None:
        host_pkg = to_numpy_tree(pkg)
        self.wait()

        def write():
            try:
                _write_package(host_pkg, path)
            except BaseException as e:  # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _drain_at_exit(self) -> None:
        try:
            self.wait()
        except RuntimeError:
            logger.exception("async checkpoint write failed at exit")


def load_package(path: str) -> dict:
    """Unpickle a package that either package wrote, without importing
    jax (`PackageUnpickler`).  Only load packages this project wrote."""
    with open(path, "rb") as f:
        unpickler = PackageUnpickler(f)
        pkg = unpickler.load()
    if unpickler.bf16_dtypes:
        pkg = _widen_bf16(pkg, unpickler.bf16_dtypes)
    return pkg


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


def average_last_ckpts(exp_dir: str, num: int, out_path: str) -> str:
    """Average the newest `num` epoch checkpoints of `exp_dir` into
    `out_path` (`average_packages`)."""
    if num < 1:
        raise ValueError(
            f"average_last_ckpts: num must be >= 1, got {num} "
            "(num=0 would silently average EVERY checkpoint)"
        )
    save_package(average_packages(epoch_checkpoints(exp_dir)[-num:]), out_path)
    return out_path
