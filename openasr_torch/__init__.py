"""openasr_torch — the PyTorch/CUDA port of openasr_tpu for NVIDIA Hopper.

The port mirrors the JAX package's layout module for module
(`openasr_torch/models/layers.py` <-> `openasr_tpu/models/layers.py`, ...)
and reads and writes the same YAML configs, json manifests and pickled
checkpoint packages.  Each Pallas TPU kernel on a ported path has a
hand-written Hopper counterpart under `openasr_torch/kernels/csrc/`, built
with nvcc at first use; its plain PyTorch version serves CPU tensors.

This package imports torch and numpy only — never jax, flax, optax or
anything under openasr_tpu.
"""

__version__ = "0.1.0"

from openasr_torch.config import Config, load_config  # noqa: F401
