"""The port's online wave path against the JAX package's, on the CPU.

Raw 16 kHz PCM goes through the data path (SpeechDataset,
TimeBasedSampler, WaveCollate), the fbank frontend and the models of the
earlier slices; each stage is held against the JAX package on the same
numpy inputs.  Tolerances:

- batches: exact (the same NumPy code on the same files);
- encoder outputs 1e-4 abs, losses 1e-5 relative: the JAX fbank takes its
  rfft path on the CPU, the port the folded products of its fused kernel,
  and their log-mel features differ by up to 3e-4 on real audio
  (tests/test_torch_fbank.py); on these tone waves the small model's
  outputs differ by 5.1e-6 and its losses by 1.5e-7 relative;
- decoding: identical hypothesis files, n-best scores within 1e-3.

The repairs of offline assumptions each have a test here: the solver's
empty-row check on a wave batch (no `feat_lengths`), the forward's and
`has_empty_rows`'s mapping of sample counts to frames, and the infer
CLI's.  The milestone trains a small fbank model with the port's CLI and
decodes it with both CLIs without `--offline`.
"""

import copy
import json
import logging
import os
import re
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_torch.bin import infer as port_infer
from openasr_torch.bin import train as port_train
from openasr_torch.data.audio import write_wav
from openasr_torch.data.collate import gen_causal_targets
from openasr_torch.models import get_model_class
from openasr_torch.models.layers import TrainRNG
from openasr_torch.utils.checkpoint import load_package, save_package

from test_torch_models import small_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "egs", "aishell1", "configs")
ENC_TOL = 1e-4
LOSS_RTOL = 1e-5
SCORE_TOL = 1e-3


@pytest.fixture(scope="module")
def wave_corpus(tmp_path_factory):
    """tools/gen_mini_corpus.py --wave: 16 tone-coded PCM16 utterances of
    0.18-0.4 s over 4 characters, and an 8-utterance dev/test set."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import gen_mini_corpus
    finally:
        sys.path.pop(0)
    out = str(tmp_path_factory.mktemp("wave_corpus"))
    gen_mini_corpus.main(["--out", out, "--wave", "--num_utts", "16"])
    return out


def online_config(model_type="conv-ctc-transformer", vocab=20, **signal):
    cfg = small_config(model_type, vocab=vocab)
    cfg["signal"] = {"feature_type": "fbank", "num_mel_bins": 20, "use_energy": False,
                     "sample_rate": 16000, **signal}
    return cfg


def build_pair(cfg):
    """(JAX model, port) holding the port's seeded weights, handed to the
    JAX create_model in place of its eager flax init."""
    port = get_model_class(cfg["type"]).create_model(cfg, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        jax_model = jax_model_class(cfg["type"]).create_model(cfg)
    return jax_model, port


def tone_waves(lengths, seed=0):
    """Padded PCM-scale waves: a tone per utterance plus noise."""
    rng = np.random.RandomState(seed)
    waves = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        waves[i, :n] = np.round(3000 * np.sin(2 * np.pi * (300 + 150 * i) * t)
                                + 80 * rng.randn(n))
    return waves


def wave_batch(lengths=(9000, 6000, 3800), seed=0):
    rng = np.random.RandomState(seed)
    toks = [list(rng.randint(4, 20, size=n)) for n in (5, 3, 2)[: len(lengths)]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=True, max_len=8)
    return {"waves": tone_waves(lengths, seed), "wave_lengths": np.asarray(lengths, np.int32),
            "ids": ids, "labels": labels, "paddings": paddings}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    return build_pair(online_config())


@pytest.fixture(scope="module")
def jax_losses(pair):
    """The JAX model's jitted loss dict of a wave batch."""
    jax_model, _ = pair
    run = jax.jit(lambda p, b: jax_model.loss(p, b, {}, train=False, label_smooth=0.1))

    def losses(batch):
        return {k: float(v) for k, v in run(jax_model.params, batch).items()}

    return losses


# ------------------------------------------------------------------ data

def test_wave_batches_match_the_jax_data_path(wave_corpus):
    from openasr_tpu.data.collate import WaveCollate as JaxCollate
    from openasr_tpu.data.manifest import SpeechDataset as JaxDataset
    from openasr_tpu.data.sampler import TimeBasedSampler as JaxSampler
    from openasr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
    from openasr_torch.data.collate import WaveCollate
    from openasr_torch.data.manifest import SpeechDataset
    from openasr_torch.data.sampler import TimeBasedSampler
    from openasr_torch.data.tokenizer import CharTokenizer

    vocab = os.path.join(wave_corpus, "train_chars.txt")
    for name, kw, shuffle in (("train_wav.json", {"label_range": (1, 60)}, True),
                              ("dev_wav.json", {"reverse": True}, False)):
        path = os.path.join(wave_corpus, name)
        sides = []
        for ds_cls, smp_cls, col_cls, tok_cls in (
            (SpeechDataset, TimeBasedSampler, WaveCollate, CharTokenizer),
            (JaxDataset, JaxSampler, JaxCollate, JaxTokenizer),
        ):
            ds = ds_cls(path, feat_range=(1, 400000), **kw)
            sampler = smp_cls(ds, 12000, 1, shuffle=shuffle)
            collate = col_cls(tok_cls(vocab, add_blk=True), True, expected_rate=16000)
            # two passes: the shuffled batch order of each epoch
            sides.append([collate([ds[i] for i in idx]) for _ in range(2) for idx in sampler])
        port, ref = sides
        assert len(port) == len(ref) >= 4
        for a, b in zip(port, ref):
            assert a.keys() == b.keys() and a["uttids"] == b["uttids"]
            for k in ("waves", "wave_lengths", "ids", "labels", "paddings"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            assert a["waves"].shape[1] >= a["wave_lengths"].max()


def test_a_file_at_another_sample_rate_is_refused(tmp_path):
    from openasr_tpu.data.collate import load_wave_batch as jax_load_wave_batch
    from openasr_torch.data.collate import load_wave_batch

    path = str(tmp_path / "8k.wav")
    write_wav(path, 8000, tone_waves([4000])[0])
    for load in (load_wave_batch, jax_load_wave_batch):
        with pytest.raises(ValueError, match="sample rate 8000"):
            load([path], expected_rate=16000)
    waves, lengths = load_wave_batch([path])
    assert lengths.tolist() == [4000] and waves.shape[1] >= 4000


# ----------------------------------------------------------------- model

def test_encoder_and_loss_match_jax(pair, jax_losses):
    jax_model, port = pair
    batch = wave_batch()
    enc_j, elens_j = jax.jit(jax_model.encode)(jax_model.params, batch["waves"],
                                               batch["wave_lengths"])
    with torch.no_grad():
        enc_t, elens_t = port.encode(*(torch.from_numpy(batch[k])
                                       for k in ("waves", "wave_lengths")))
        losses = port.loss(_t(batch), None, label_smooth=0.1)
    assert np.array_equal(np.asarray(elens_j), elens_t.numpy())
    assert np.abs(np.asarray(enc_j) - enc_t.numpy()).max() <= ENC_TOL
    want = jax_losses(batch)
    for k, v in want.items():
        assert abs(float(losses[k]) - v) <= LOSS_RTOL * abs(v), (k, float(losses[k]), v)


def test_packages_move_both_ways(pair):
    """An fbank model's package (no frontend parameters) restores in both
    packages: JAX's into the port, and the port's into JAX."""
    jax_model, port = pair
    cfg = online_config()
    other = get_model_class("conv-ctc-transformer").create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    other.restore(jax_model.package())
    for name, t in port.module.state_dict().items():
        assert torch.equal(other.module.state_dict()[name], t), name
    fresh = get_model_class("conv-ctc-transformer").create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    jax_model.restore(fresh.package())
    batch = wave_batch(seed=1)
    enc_j, _ = jax.jit(jax_model.encode)(jax_model.params, batch["waves"],
                                         batch["wave_lengths"])
    with torch.no_grad():
        enc_t, _ = fresh.encode(torch.from_numpy(batch["waves"]),
                                torch.from_numpy(batch["wave_lengths"]))
    jax_model.restore(port.package())  # back to the module fixture's weights
    assert np.abs(np.asarray(enc_j) - enc_t.numpy()).max() <= ENC_TOL


def test_training_forward_with_spec_aug_and_dither_under_bf16_autocast():
    """SpecAugment and dither on, bf16 autocast: the frontend still hands
    the encoder f32 features of the right shape, the dither follows the
    step's device generator, and the losses are finite."""
    spec = {"freq_mask_num": 2, "freq_mask_width": 5, "time_mask_num": 2,
            "time_mask_width": 8}
    cfg = online_config(spec_aug=spec, dither=True)
    port = get_model_class("conv-ctc-transformer").create_model(cfg, device="cpu")
    seen = []
    port.module.splayer.register_forward_hook(lambda m, i, o: seen.append(o))
    batch = _t(wave_batch())
    for seed in (5, 5, 6):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            losses = port.loss(batch, TrainRNG(seed, "cpu"), label_smooth=0.1)
        assert all(torch.isfinite(v).all() for v in losses.values())
    feats = [o[0] for o in seen]
    assert all(f.dtype == torch.float32 and f.shape == (3, 54, 20) for f in feats)
    assert seen[0][1].tolist() == [54, 36, 22]
    assert torch.equal(feats[0], feats[1]) and not torch.equal(feats[0], feats[2])
    with torch.no_grad():  # no rng: no SpecAugment, no dither
        plain, _ = port.module.splayer(batch["waves"], batch["wave_lengths"])
    assert not torch.equal(plain, feats[0]) and port.module.splayer.apply_dither


# --------------------------------------------------------------- repairs

def test_solver_checks_empty_rows_of_a_wave_batch(tmp_path):
    """Repair 1: a wave batch has no `feat_lengths`; the solver takes the
    lengths the model reads (`batch_inputs`)."""
    from openasr_torch.solvers import get_solver_class

    port = get_model_class("conv-ctc-transformer").create_model(online_config(), device="cpu")
    config = {"num_epoch": 1, "exp_dir": str(tmp_path), "init_lr": 1.0,
              "lr_scheduler": {"type": "warmup_transformer", "warmup_step": 10, "d_model": 64}}
    batch = wave_batch()
    solver = get_solver_class("conv-ctc-transformer")(
        port, config, [batch], [batch], device="cpu")
    cv = solver.iter_one_epoch(cross_valid=True)
    assert np.isfinite(cv)
    solver.iter_one_epoch()
    assert solver.step == 1


def test_empty_rows_are_counted_in_frames_not_samples(pair, jax_losses):
    """Repair 2: an utterance shorter than one window (300 samples) has 0
    fbank frames and no encoder frame.  `has_empty_rows` and the forward
    map sample counts through `num_frames_of` first, so the forward takes
    the dense value on that row, as JAX does, with no `empty_rows` hint."""
    jax_model, port = pair
    assert port.has_empty_rows(np.array([9000, 300, 3800]))
    assert not port.has_empty_rows(np.array([9000, 6000, 3800]))
    assert port.module.encoder_lengths(np.array([399, 400, 3800])).tolist() == [-1, -1, 4]
    batch = wave_batch(lengths=(9000, 300, 3800), seed=2)
    with torch.no_grad():
        losses = port.loss(_t(batch), None, label_smooth=0.1)
    want = jax_losses(batch)
    for k, v in want.items():
        assert abs(float(losses[k]) - v) <= LOSS_RTOL * abs(v), (k, float(losses[k]), v)


def write_wave_manifest(path, rows):
    with open(path, "w") as f:
        json.dump(rows, f)
    return str(path)


def test_infer_cli_passes_empty_rows_of_a_wave_batch(wave_corpus, tmp_path, monkeypatch):
    """Repair 3: the infer CLI's empty-row flag for a wave batch holding a
    300-sample utterance is True."""
    from openasr_torch.models.speech import ConvTransformer

    from openasr_torch.data.tokenizer import CharTokenizer

    vocab = os.path.join(wave_corpus, "train_chars.txt")
    port = get_model_class("conv-ctc-transformer").create_model(
        online_config(vocab=CharTokenizer(vocab, add_blk=True).unit_num()), device="cpu")
    pkg = str(tmp_path / "m.pkg")
    save_package(port.package(), pkg)
    short = str(tmp_path / "short.wav")
    write_wav(short, 16000, tone_waves([300])[0])
    rows = json.load(open(os.path.join(wave_corpus, "test_wav.json")))[:2]
    rows.append({"uttid": "short", "feat": short, "feat_length": 300, "tokens": "a",
                 "token_length": 1})
    manifest = write_wave_manifest(tmp_path / "test.json", rows)
    seen = []
    decode = ConvTransformer.batch_beam_decode

    def spy(self, inputs, lengths, *a, **k):
        seen.append((inputs.shape, k["empty_rows"]))
        return decode(self, inputs, lengths, *a, **k)

    monkeypatch.setattr(ConvTransformer, "batch_beam_decode", spy)
    port_infer.main(["--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
                     "--vocab_path", vocab, "--json_file", manifest, "--output", str(tmp_path / "hyp.txt"),
                     "--add_blk", "--nbest", "2", "--maxlen", "4",
                     "--batch_frames", "100000", "--device", "cpu"])
    assert len(seen) == 1 and seen[0][1] is True and seen[0][0][0] == 3
    assert len((tmp_path / "hyp.txt").read_text().splitlines()) == 3


# ------------------------------------------------------------- milestone

def milestone_config(corpus, exp_dir):
    cfg = {
        "data": {"trainset": os.path.join(corpus, "train_wav.json"),
                 "devset": os.path.join(corpus, "dev_wav.json"),
                 "vocab_path": os.path.join(corpus, "train_chars.txt"),
                 "feat_range": "1,400000", "label_range": "1,60", "fetchworker_num": 0},
        "model": online_config(),
        "training": {"label_type": "tokens", "batch_time": 20000, "exp_dir": str(exp_dir),
                     "print_inteval": 1, "num_epoch": 2, "accumulate_grad_batch": 1,
                     "init_lr": 0.001, "optimtype": "adam", "grad_max_norm": 5.0,
                     "label_smooth": 0.1, "lambda_ctc": 0.5,
                     "lr_scheduler": {"type": "warmup_transformer", "warmup_step": 10,
                                      "d_model": 64}},
    }
    cfg["model"]["decoder"]["vocab_size"] = -1
    return cfg


def _nbest_scores(text):
    return [float(s) for s in re.findall(r"score: (-?[0-9.]+)", text)]


def test_milestone_train_then_decode_waves_with_both_clis(wave_corpus, tmp_path, caplog):
    """The port's train CLI trains a small fbank conv-ctc-transformer on the
    wave corpus; the port's and the JAX package's infer CLIs decode its
    package from the wave manifest (no --offline) to identical hypotheses."""
    from openasr_tpu.bin.infer import main as jax_infer

    exp = tmp_path / "exp"
    cfg_path = tmp_path / "online.yaml"
    cfg_path.write_text(yaml.safe_dump(milestone_config(wave_corpus, exp)))
    port_train.main([str(cfg_path), "--device", "cpu"])
    rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    train_rows = [r for r in rows if r["phase"] == "train"]
    assert len(train_rows) >= 6 and all(np.isfinite(r["ce_loss"]) for r in train_rows)
    assert load_package(str(exp / "last.pkg"))["solver_state"]["epoch"] == 2

    argv = ["--model_type", "conv-ctc-transformer", "--model_pkg", str(exp / "last.pkg"),
            "--vocab_path", os.path.join(wave_corpus, "train_chars.txt"),
            "--json_file", os.path.join(wave_corpus, "test_wav.json"),
            "--add_blk", "--nbest", "3", "--maxlen", "8", "--batch_frames", "20000"]
    caplog.set_level(logging.INFO)
    jax_infer(argv + ["--output", str(tmp_path / "hyp_jax.txt")])
    jax_log = caplog.text
    caplog.clear()
    port_infer.main(argv + ["--output", str(tmp_path / "hyp_torch.txt"), "--device", "cpu"])
    hyp_jax = (tmp_path / "hyp_jax.txt").read_text()
    assert len(hyp_jax.splitlines()) == 8
    assert (tmp_path / "hyp_torch.txt").read_text() == hyp_jax
    s_jax, s_torch = _nbest_scores(jax_log), _nbest_scores(caplog.text)
    assert len(s_jax) == len(s_torch) == 24
    assert np.abs(np.array(s_jax) - np.array(s_torch)).max() <= SCORE_TOL


def test_recipe_gate_config_trains_through_the_port(wave_corpus, tmp_path):
    """egs/aishell1/configs/conv-ctc-recipe-gate.yaml (conv-ctc, online
    fbank, SpecAugment, bf16, newbob) validates without a warning and
    trains one epoch through the port's CLI on the CPU."""
    from openasr_torch.config import validate_config

    with open(os.path.join(CONFIGS, "conv-ctc-recipe-gate.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert validate_config(cfg) == []
    cfg["data"].update(trainset=os.path.join(wave_corpus, "train_wav.json"),
                       devset=os.path.join(wave_corpus, "dev_wav.json"),
                       vocab_path=os.path.join(wave_corpus, "train_chars.txt"),
                       fetchworker_num=0)
    cfg["training"].update(exp_dir=str(tmp_path / "exp"), num_epoch=1, print_inteval=1)
    path = tmp_path / "gate.yaml"
    path.write_text(yaml.safe_dump(cfg))
    port_train.main([str(path), "--device", "cpu"])
    rows = [json.loads(line) for line in open(tmp_path / "exp" / "metrics.jsonl")]
    assert rows[-1]["phase"] == "epoch" and np.isfinite(rows[-1]["cv_loss"])
    assert all(np.isfinite(r["ctc_loss"]) for r in rows if r["phase"] == "train")


def test_online_flagship_config_validates_in_both_packages():
    from openasr_tpu.config import validate_config as jax_validate
    from openasr_torch.config import validate_config

    with open(os.path.join(CONFIGS, "conv-ctc-transformer-online.yaml")) as f:
        online = yaml.safe_load(f)
    with open(os.path.join(CONFIGS, "conv-ctc-transformer.yaml")) as f:
        offline = yaml.safe_load(f)
    assert validate_config(online) == [] and jax_validate(online) == []
    # the flagship's model and training sections, but for the frontend and
    # the batch budget (36000 frames x 160 samples)
    want = copy.deepcopy(offline)
    want["model"]["signal"] = {"feature_type": "fbank", "num_mel_bins": 80,
                               "use_energy": False, "sample_rate": 16000,
                               "spec_aug": offline["model"]["signal"]["spec_aug"]}
    want["training"]["batch_time"] = want["training"].pop("batch_frames") * 160
    want["training"]["exp_dir"] = online["training"]["exp_dir"]
    assert online["model"] == want["model"] and online["training"] == want["training"]


@pytest.mark.parametrize("model_type,signal,training,error,match", [
    # the text families exit naming their own training CLIs
    pytest.param("embed_decoder", {"feature_type": "fbank"}, {"batch_time": 1000}, SystemExit,
                 "openasr_torch.bin.train_phone2char",
                 id="embed_decoder-signal0-training0-SystemExit-item 13"),
    (None, {"feature_type": "fbank"}, {"batch_frames": 1000}, ValueError,
     "training.batch_time"),
    (None, {"feature_type": "offline"}, {"batch_time": 1000}, ValueError,
     "training.batch_frames"),
])
def test_train_cli_checks_the_frontend_and_its_budget(wave_corpus, tmp_path, model_type,
                                                      signal, training, error, match):
    cfg = milestone_config(wave_corpus, tmp_path / "exp")
    cfg["model"]["type"] = model_type or cfg["model"]["type"]
    cfg["model"]["signal"] = signal
    del cfg["training"]["batch_time"]
    cfg["training"].update(training)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(error, match=match):
        port_train.main([str(path), "--device", "cpu"])
