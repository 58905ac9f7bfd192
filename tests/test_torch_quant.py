"""The port's weight-only int8 quantization (openasr_torch/quant.py) against
the JAX package's (openasr_tpu/quant.py), on the CPU.

The same package components (flax layout, NumPy) go through both
quantizers: the int8 values and the scales are equal, and the port's
dequantized weights in the torch layout (`bridge_quantized`, then q *
scale in torch) equal, bit for bit, the JAX package's dequantized weights
bridged by convert.py.  The packages: the flagship's test config (d32,
where one leaf is large enough to quantize), the same at d64 with a
two-layer ConvV2 (q/k/v, out, Dense, HWIO convolution and embedding
leaves), a Transformer LM and an LSTM LM.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from openasr_torch import quant
from openasr_torch.config import Config
from openasr_torch.convert import jax_components_to_state_dict
from openasr_torch.models import get_model_class
from openasr_tpu import quant as jax_quant

TEST_YAML = "egs/aishell1/configs/conv-ctc-transformer-test.yaml"


def flagship_test(d_model=None):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, TEST_YAML)) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg["decoder"]["vocab_size"] = 80
    if d_model:
        for section in ("encoder", "decoder"):
            cfg[section].update(d_model=d_model, nhead=4, dim_feedforward=2 * d_model)
        cfg["decoder"]["encoder_dim"] = d_model
        cfg["encoder"]["sub"]["layer_num"] = 2
    return cfg


PACKAGES = {
    "flagship test": lambda: flagship_test(),
    "flagship test d64": lambda: flagship_test(64),
    "transformer_lm": lambda: {"type": "transformer_lm", "vocab_size": 80, "d_model": 64,
                               "nhead": 4, "num_layers": 2, "dim_feedforward": 128,
                               "dropout_rate": 0.0},
    "lstm_lm": lambda: {"type": "lstm_lm", "vocab_size": 80, "d_model": 64, "n_layers": 2,
                        "dropout_rate": 0.0},
}


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_quantize_matches_jax_bit_for_bit(name):
    cfg = PACKAGES[name]()
    model = get_model_class(cfg["type"]).create_model(
        Config(cfg), device="cpu", generator=torch.Generator().manual_seed(3))
    pkg = model.package()
    comps, mtype = pkg["components"], pkg["model_type"]
    jq = jax.tree_util.tree_map(np.asarray, jax_quant.quantize_params(comps))
    pq = quant.quantize_params(comps)

    def pairs(jtree, ptree):
        for k in jtree:
            if jax_quant.is_quantized_leaf(jtree[k]) or not isinstance(jtree[k], dict):
                yield jtree[k], ptree[k]
            else:
                yield from pairs(jtree[k], ptree[k])

    n_q = 0
    for j, p in pairs(jq, pq):
        assert quant.is_quantized_leaf(p) == jax_quant.is_quantized_leaf(j)
        if quant.is_quantized_leaf(p):
            n_q += 1
            assert p[quant.Q_KEY].dtype == np.int8
            np.testing.assert_array_equal(p[quant.Q_KEY], j[jax_quant.Q_KEY])
            np.testing.assert_array_equal(p[quant.SCALE_KEY], j[jax_quant.SCALE_KEY])
    assert n_q >= (1 if name == "flagship test" else 6)
    assert quant.quantization_error(comps, pq) <= 0.5

    # through the bridge: q equal, scales equal (broadcast to q's torch
    # layout), dequantized weights equal bit for bit
    bridged = quant.bridge_quantized(mtype, pq, Config(cfg))
    jax_deq = jax.tree_util.tree_map(np.asarray, jax_quant.dequantize_params(jq))
    want = jax_components_to_state_dict(mtype, jax_deq, configs=Config(cfg))
    def bridged_jax(fn):
        """The bridge of the JAX tree with fn(leaf) for each quantized leaf."""
        tree = jax.tree_util.tree_map(lambda n: fn(n) if jax_quant.is_quantized_leaf(n) else n,
                                      jq, is_leaf=jax_quant.is_quantized_leaf)
        return jax_components_to_state_dict(mtype, tree, configs=Config(cfg))

    want_q = bridged_jax(lambda n: n[jax_quant.Q_KEY])
    want_s = bridged_jax(lambda n: np.broadcast_to(n[jax_quant.SCALE_KEY], n[jax_quant.Q_KEY].shape))
    assert set(bridged) == set(want) == set(model.module.state_dict())
    deq = quant.dequantize_params(bridged)
    for key, entry in bridged.items():
        assert deq[key].dtype == torch.float32
        assert torch.equal(deq[key], want[key]), key
        if quant.is_quantized_leaf(entry):
            q, s = entry[quant.Q_KEY], entry[quant.SCALE_KEY]
            assert q.dtype == torch.int8 and q.shape == want[key].shape
            assert torch.equal(q.float(), want_q[key]), key
            assert torch.equal(s.expand(q.shape), want_s[key]), key
            assert s.numel() < q.numel()  # a scale per channel, not per weight


def test_quantize_roundtrip_error_bound():
    """tests/test_quant.py's tree: per-channel scales adapt to channel
    magnitudes across 4 orders; 1-D, small and integer leaves pass."""
    rng = np.random.RandomState(0)
    params = {
        "enc": {"w": (rng.randn(64, 128) * np.logspace(-3, 1, 128)).astype(np.float32),
                "b": rng.randn(128).astype(np.float32)},
        "small": rng.randn(4, 4).astype(np.float32),
        "ids": np.arange(10, dtype=np.int32),
    }
    q = quant.quantize_params(params)
    assert quant.is_quantized_leaf(q["enc"]["w"])
    assert q["enc"]["w"][quant.Q_KEY].dtype == np.int8
    assert not quant.is_quantized_leaf(q["enc"]["b"]) and not quant.is_quantized_leaf(q["small"])
    assert q["ids"].dtype == np.int32
    assert quant.quantization_error(params, q) <= 0.5 + 1e-6
    deq = quant.dequantize_params(q)
    w, dw = params["enc"]["w"], np.asarray(deq["enc"]["w"])
    assert dw.dtype == np.float32
    amax = np.abs(w).max(axis=0)
    assert float(np.max(np.abs(w - dw) / amax)) <= (1.0 / 254 + 1e-6)
    np.testing.assert_array_equal(np.asarray(deq["enc"]["b"]), params["enc"]["b"])


@pytest.mark.parametrize("as_torch", [False, True])
def test_zero_channel_and_negative_extreme(as_torch):
    """A zero channel dequantizes to 0 (its scale is 0); a symmetric
    -amax hits -127 exactly; in NumPy and in torch."""
    params = {"w": np.zeros((64, 64), np.float32)}
    params["w"][:, 1] = -3.0
    q = quant.quantize_params(params)
    assert q["w"][quant.Q_KEY][:, 1].tolist() == [-127] * 64
    assert q["w"][quant.SCALE_KEY][0] == 0.0
    if as_torch:
        q = {"w": {k: torch.from_numpy(v) for k, v in q["w"].items()}}
    deq = np.asarray(quant.dequantize_params(q)["w"])
    np.testing.assert_allclose(deq, params["w"], atol=1e-7)
    jq = jax_quant.quantize_params(params)
    np.testing.assert_array_equal(np.asarray(jax_quant.dequantize_params(jq)["w"]), deq)
