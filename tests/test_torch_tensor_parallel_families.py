"""Tensor and sequence parallelism of the port's other families, on the CPU.

Each family trains 3 solver steps on a grid of gloo ranks
(tests/torch_parallel_ranks.py), through tests/test_torch_parallel_families.py's
`run_family`: the ranks and the port's one-process run against the JAX
solver's step on one device (losses 1e-5, parameters and running
statistics 1e-5 of max(1, |x|), the first step's gradients 1e-5 of the
one-process run and 1e-4 of the JAX run), dropout 0, ZeRO-1 on:
- at dp1 x tp2: ctc_cif (its decoder's vocab-parallel embedding, its
  output_affine and CTC head replicated; the quantity loss over the data
  group), the WGAN-GP GAN (G's embedding and encoder block over the model
  group, D replicated; the penalty's mean over the data group) and
  wav2vec_ctc's freeze gate;
- at dp2 x tp2: GRU-CTC (no layer for the model axis: its BatchNorm
  statistics and gradients over the data group alone, not the world, whose
  sum would count each row twice) and the MoE flagship with the topk and
  expert_choice routers (experts over data, their F over model).
"""

import jax
import numpy as np
import pytest

from test_torch_cif import cif_config
from test_torch_gan import GAN_CFG
from test_torch_parallel import (
    FLAGSHIP_BATCHES,
    TRAINING,
    first_moment,
    jax_train,
    losses_close,
    params_close,
    port_package,
)
from test_torch_parallel_families import (
    WAVES,
    cif_batch,
    phone_batch,
    run_family,
    tokens_batch,
)
from test_torch_parallel_moe import MOE_MODEL, TABLES
from test_torch_wave_models import GRU_CFG, W2V_CFG
from torch_parallel_ranks import RankPool


@pytest.fixture(scope="module")
def grid2():
    pool = RankPool(2, model=2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def grid4():
    pool = RankPool(4, model=2)
    yield pool
    pool.close()


def test_ctc_cif(grid2, tmp_path):
    import openasr_tpu.models.cif as jax_cif

    cfg = cif_config("ctc_cif")
    cfg["encoder"]["dropout_rate"] = cfg["decoder"]["dropout_rate"] = 0.0
    cfg["assigner"]["dropout"] = 0.0
    batches = [cif_batch(i, lens) for i, lens in enumerate(
        [(41, 30, 19, 35), (22, 47, 33, 28), (30, 31, 52, 18)])]
    pkg, draws = port_package("ctc_cif", cfg), []
    scale_alphas = jax_cif.scale_alphas

    def recording(alphas, target_lengths, noise_key=None):
        if noise_key is not None:
            jax.debug.callback(lambda u: draws.append(np.asarray(u)),
                               jax.random.uniform(noise_key, target_lengths.shape))
        return scale_alphas(alphas, target_lengths, noise_key)

    (tmp_path / "jax").mkdir()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_cif, "scale_alphas", recording)
        want = jax_train("ctc_cif", cfg, pkg, dict(TRAINING, exp_dir=str(tmp_path)), batches,
                         tmp_path / "jax")
    assert [d.shape for d in draws] == [(4,)] * 3
    outs, _ = run_family(grid2, tmp_path, "ctc_cif", cfg, batches, want=want, pkg=pkg,
                         draws=draws)
    # the decoder's embedding is vocab-parallel: ceil(V / 2) rows on rank
    # 0; the CTC head and output_affine whole
    vocab = pkg["components"]["decoder"]["emb"]["embedding"].shape[0]
    assert outs[0]["shards"]["decoder.emb.weight"][0] == -(-vocab // 2)
    assert outs[1]["shards"]["decoder.emb.weight"][0] == vocab // 2
    assert outs[0]["shards"]["ctc_fc.weight"][0] == vocab


def test_gan(grid2, tmp_path):
    """As tests/test_torch_parallel_families.py's GAN, on dp1 x tp2: the
    paired, unpaired-phone and unpaired-text batches each whole on both
    ranks of the model group."""
    import torch

    from openasr_torch.models import get_model_class

    port = get_model_class("gan_phone2char").create_model(
        GAN_CFG, device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port.module.G.ctc_fc.weight[-1].zero_()
    paired = [phone_batch(30 + i, lens) for i, lens in enumerate([(7, 5, 4, 9), (3, 8, 6, 6)])]
    phones = [tokens_batch(40 + i, lens, 15) for i, lens in enumerate(
        [(9, 7, 3, 5), (4, 8, 6, 9), (5, 5, 9, 3)])]
    texts = [tokens_batch(50 + i, lens, 20) for i, lens in enumerate(
        [(16, 12, 5, 9), (6, 14, 10, 8)])]
    combined = [dict(paired[i % 2], unpaired_phones=phones[i]["tokens"],
                     unpaired_phone_lengths=phones[i]["token_lengths"],
                     unpaired_text=texts[i % 2]["tokens"],
                     unpaired_text_lengths=texts[i % 2]["token_lengths"]) for i in range(3)]
    alphas = [np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(i), 1),
                                            (4, 1, 1))) for i in range(3)]
    outs, one = run_family(grid2, tmp_path, "gan_phone2char", GAN_CFG, paired,
                           training={"print_inteval": 1}, pkg=port.package(), draws=alphas,
                           jax_batches=combined, phone_loader=phones, text_loader=texts)
    assert one["step"] == 3 and all(out["step"] == 3 for out in outs)


def test_wav2vec_freeze_gate(grid2, tmp_path):
    cfg = {**W2V_CFG, "encoder": {**W2V_CFG["encoder"], "freeze_finetune_updates": 2}}
    outs, _ = run_family(grid2, tmp_path, "wav2vec_ctc", cfg, WAVES)
    assert "gate_count" in outs[0]["pkg"]["optim_state"]


def test_gru_ctc_statistics_over_the_data_group(grid4, tmp_path):
    outs, one = run_family(grid4, tmp_path, "gru_ctc", GRU_CFG, WAVES)
    for out in outs:
        params_close(out["pkg"]["model"]["batch_stats"], one["pkg"]["model"]["batch_stats"],
                     what="batch_stats")
        assert not out["model_calls"]


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_moe_experts_over_data_and_width_over_model(grid4, tmp_path, router):
    """tests/test_moe.py:373's promise on dp2 x tp2: each rank holds 2 of
    the 4 experts at half their inner width (its optimizer state too), and
    trains as one process and the JAX package do."""
    cfg = {**MOE_MODEL, "encoder": {**MOE_MODEL["encoder"], "moe": {
        **MOE_MODEL["encoder"]["moe"], "router": router}}}
    outs, one = run_family(grid4, tmp_path, "conv-ctc-transformer", cfg, FLAGSHIP_BATCHES)
    for out in outs:
        losses_close(out["aux"], one["aux"])
        assert out["calls"]["all_to_all"] == 4
    full = {n: v.shape for n, v in first_moment(outs[0]["pkg"]["optim_state"]).items()}
    f_dim = {"w1": 2, "w_gate": 2, "b1": 1, "b_gate": 1, "w2": 1}
    tables = [n for n in full if "moe_ffn" in n and n.split(".")[-1] in TABLES]
    assert len(tables) == 6
    for name in tables:
        want = list(full[name])
        want[0] //= 2
        leaf = name.split(".")[-1]
        if leaf in f_dim:
            want[f_dim[leaf]] //= 2
        assert outs[0]["shards"][name] == tuple(want), name
