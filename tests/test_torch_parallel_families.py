"""Data parallelism of the port's other families, on the CPU.

Each family trains 3 solver steps at world 2 (gloo ranks,
tests/torch_parallel_ranks.py) on global batches whose rank slices have
different natural lengths, dropout 0, ZeRO-1 on (the default), SGD with
momentum at a constant rate (tests/test_torch_parallel.py's `TRAINING`):
- GRU-CTC (WavConv's BatchNorm: statistics over the global batch, the
  gradient through the all-reduced sums), wav2vec_ctc (its freeze gate
  opens at step 3, the stock optimizer with the gate first),
  Embed_Decoder_CTC (ctc / n_tokens), CIF (its quantity noise a row; the
  quantity loss, a root of a sum over the batch, as the ranks' shares of
  the global root) and the WGAN-GP GAN (the penalty's alpha a row; its
  mean over the global batch) against the JAX solver's step on one
  device: losses 1e-5, parameters and running statistics 1e-5 of max(1,
  |x|), the first step's gradients 1e-5 of the port's one-process run and
  1e-4 of the JAX run (tests/test_torch_parallel.py).  The port draws its
  per-row values from its host generator and the JAX package from its key
  (ROADMAP queue 3 items 23 and 28), so CIF's and the GAN's ranks and
  one-process run are given the JAX draws of the global batch, each rank
  its rows: CIF's noise recorded from inside the JAX step, the GAN's alpha
  drawn from the key that the step derives it from;
- CPC (the anchor's bound from the global batch's shortest utterance, each
  row's negative a row of the global batch, on any rank) against the
  port's one-process run, to the same tolerances; tests/test_torch_cpc.py
  holds the one-process port to the JAX package at the JAX draws.
"""

import jax
import numpy as np
import pytest
import torch

from openasr_torch.data.collate import gen_causal_targets
from openasr_torch.parallel import Grid

from test_torch_cif import cif_config
from test_torch_cpc import CPC_CFG
from test_torch_gan import GAN_CFG
from test_torch_parallel import (
    TRAINING,
    check_against_jax,
    grads_close,
    jax_train,
    losses_close,
    params_close,
    port_package,
)
from test_torch_text import p2c_config
from test_torch_wave_models import GRU_CFG, W2V_CFG
from torch_parallel_ranks import RankPool, natural, train


@pytest.fixture(scope="module")
def pool2():
    pool = RankPool(2)
    yield pool
    pool.close()


def targets(rng, b, vocab, add_eos):
    """5 tokens in the first row, 1-4 in the others: the global batches of
    a family share their shapes, so the JAX reference compiles once."""
    toks = [list(rng.randint(3, vocab - 1, size=5 if i == 0 else rng.randint(1, 5)))
            for i in range(b)]
    return dict(zip(("ids", "labels", "paddings"),
                    gen_causal_targets(toks, add_eos=add_eos, max_len=8)))


def wave_batch(seed, lengths, vocab=12):
    rng = np.random.RandomState(seed)
    waves = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = rng.randn(n) * 2000.0
    return natural({"waves": waves, "wave_lengths": np.asarray(lengths, np.int32),
                    **targets(rng, len(lengths), vocab, False)})


def cif_batch(seed, lengths, vocab=12):
    rng = np.random.RandomState(seed)
    feats = np.zeros((len(lengths), max(lengths), 20), np.float32)
    for i, n in enumerate(lengths):
        feats[i, :n] = rng.randn(n, 20)
    return natural({"feats": feats, "feat_lengths": np.asarray(lengths, np.int32),
                    **targets(rng, len(lengths), vocab, False)})


def phone_batch(seed, phone_lengths, phone_vocab=15, char_vocab=20):
    rng = np.random.RandomState(seed)
    b = len(phone_lengths)
    phones = np.full((b, max(phone_lengths)), 2, np.int32)
    for i, n in enumerate(phone_lengths):
        phones[i, :n] = rng.randint(3, phone_vocab - 1, n)
    tlen = [max(1, n // 2) for n in phone_lengths]
    u = 5
    return natural({
        "phones": phones, "phone_lengths": np.asarray(phone_lengths, np.int32),
        "ids": rng.randint(3, char_vocab - 1, (b, u)).astype(np.int32),
        "labels": rng.randint(3, char_vocab - 1, (b, u)).astype(np.int32),
        "paddings": (np.arange(u)[None, :] >= np.asarray(tlen)[:, None]).astype(np.float32)})


def tokens_batch(seed, lengths, vocab):
    rng = np.random.RandomState(seed)
    tokens = np.full((len(lengths), max(lengths)), 2, np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(3, vocab - 1, n)
    return natural({"tokens": tokens, "token_lengths": np.asarray(lengths, np.int32)})


WAVES = [wave_batch(i, lens) for i, lens in enumerate(
    [(4000, 3200, 2400, 5600), (2720, 5600, 3680, 1920), (3040, 3200, 5600, 2560)])]


def run_family(pool, tmp_path, model_type, cfg, batches, training=None, want=None, pkg=None,
               draws=None, jax_batches=None, **loaders):
    """The family's ranks and one-process run against the JAX run `want`
    (made here over `jax_batches`, by default `batches`, when not given;
    False: none), the ranks against the one-process run."""
    training = dict(TRAINING, **(training or {}), exp_dir=str(tmp_path))
    pkg = pkg or port_package(model_type, cfg)
    spec = {"model_type": model_type, "model_cfg": cfg, "pkg": pkg, "training": training,
            "loaders": {"tr": batches, **loaders}}
    if draws is not None:
        spec["draws"] = draws
    one = train(Grid.single("cpu"), spec)
    outs = pool.run("train", spec)
    if want is None:
        (tmp_path / "jax").mkdir()
        want = jax_train(model_type, cfg, pkg, training, jax_batches or batches,
                         tmp_path / "jax")
    if want is not False:
        check_against_jax(outs, want, one)
    for out in outs:
        losses_close(out["losses"], one["losses"])
        grads_close(out["g1"], one["g1"])
        params_close(out["pkg"]["model"]["components"], one["pkg"]["model"]["components"])
    return outs, one


def test_gru_ctc_batch_norm_statistics_are_the_global_batchs(pool2, tmp_path):
    outs, one = run_family(pool2, tmp_path, "gru_ctc", GRU_CFG, WAVES)
    for out in outs:
        params_close(out["pkg"]["model"]["batch_stats"], one["pkg"]["model"]["batch_stats"],
                     what="batch_stats")


def test_wav2vec_freeze_gate(pool2, tmp_path):
    cfg = {**W2V_CFG, "encoder": {**W2V_CFG["encoder"], "freeze_finetune_updates": 2}}
    outs, _ = run_family(pool2, tmp_path, "wav2vec_ctc", cfg, WAVES)
    assert "gate_count" in outs[0]["pkg"]["optim_state"]


def test_embed_decoder_ctc(pool2, tmp_path):
    batches = [phone_batch(i, lens) for i, lens in enumerate(
        [(7, 5, 4, 10), (3, 10, 6, 6), (10, 4, 7, 5)])]
    run_family(pool2, tmp_path, "Embed_Decoder_CTC", p2c_config("Embed_Decoder_CTC"), batches)


def test_cif(pool2, tmp_path):
    cfg = cif_config("CIF")
    cfg["encoder"]["dropout_rate"] = cfg["decoder"]["dropout_rate"] = 0.0
    cfg["assigner"]["dropout"] = 0.0
    batches = [cif_batch(i, lens) for i, lens in enumerate(
        [(41, 30, 19, 35), (22, 47, 33, 28), (30, 31, 52, 18)])]
    import openasr_tpu.models.cif as jax_cif

    pkg, draws = port_package("CIF", cfg), []
    scale_alphas = jax_cif.scale_alphas

    def recording(alphas, target_lengths, noise_key=None):
        """The JAX step's quantity noise, as scale_alphas draws it."""
        if noise_key is not None:
            jax.debug.callback(lambda u: draws.append(np.asarray(u)),
                               jax.random.uniform(noise_key, target_lengths.shape))
        return scale_alphas(alphas, target_lengths, noise_key)

    (tmp_path / "jax").mkdir()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_cif, "scale_alphas", recording)
        want = jax_train("CIF", cfg, pkg, dict(TRAINING, exp_dir=str(tmp_path)), batches,
                         tmp_path / "jax")
    assert [d.shape for d in draws] == [(4,)] * 3
    run_family(pool2, tmp_path, "CIF", cfg, batches, want=want, pkg=pkg, draws=draws)


def test_gan(pool2, tmp_path):
    """Each iteration a paired batch, an unpaired-phone batch and an
    unpaired-text batch, all split over the ranks (the paired and text
    loaders cycle, as in both solvers); D's penalty over the global batch,
    one gradient reduced.  The JAX step i, given the key PRNGKey(i), draws
    alpha from its `aug` key fold_in(PRNGKey(i), 1)."""
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
    outs, one = run_family(pool2, tmp_path, "gan_phone2char", GAN_CFG, paired,
                           training={"print_inteval": 1}, pkg=port.package(), draws=alphas,
                           jax_batches=combined, phone_loader=phones, text_loader=texts)
    assert one["step"] == 3 and all(out["step"] == 3 for out in outs)


def test_cpc(pool2, tmp_path):
    batches = [{k: v for k, v in b.items() if k.startswith("wave")} for b in WAVES]
    outs, _ = run_family(pool2, tmp_path, "encoder_cpc", CPC_CFG, batches, want=False)
    assert outs[0]["pkg"]["model"].get("batch_stats")
