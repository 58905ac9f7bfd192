"""The other MoE-capable families against the JAX package, on the CPU:
CIF, CIF_FC and CIF_MIX (paired batches) for both routers and
conv-transformer (its CE-only loss) for topk, each with an `encoder.moe`
section, held as tests/test_torch_moe.py holds conv-ctc-transformer,
conv-ctc, ctc_cif and Embed_Decoder_CTC: the losses, `moe_aux_loss` and
every gradient within 1e-4.
"""

import pytest

from test_torch_moe import check_model_against_jax


@pytest.mark.parametrize("model_type,router", [
    ("CIF", "topk"), ("CIF", "expert_choice"), ("CIF_FC", "topk"),
    ("CIF_FC", "expert_choice"), ("CIF_MIX", "topk"), ("CIF_MIX", "expert_choice"),
    ("conv-transformer", "topk"),
])
def test_family_losses_and_gradients_match_jax(model_type, router):
    check_model_against_jax(model_type, router)
