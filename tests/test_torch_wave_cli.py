"""The raw-wave families through the port's CLIs, on the CPU, held to the
JAX package's infer CLI.

On the mini wave corpus (16 tone-coded wavs):

- `bin/train.py` trains egs/wav2vec/configs/wav2vec_ctc_test.yaml one
  epoch: the freeze gate's counter in the package, finite losses;
- `bin/train_cpc.py --type pretrain` trains CPC one epoch, then `--type
  finetune` trains gru_ctc from its package (`training.load_splayer`):
  the splayer's weights stay the pretrain package's, its running
  statistics move, and `--continue-training` picks the run up;
- each trained package, handed to the JAX package's create_model and
  saved by it, is decoded by both infer CLIs on the wave manifest:
  greedy and the host prefix beam for gru_ctc, greedy and the device
  prefix beam for wav2vec_ctc; the hyp files are equal.
"""

import copy
import json
import logging
import os

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import yaml

from openasr_torch.bin import gen_mini_corpus, train, train_cpc
from openasr_torch.bin.infer import main as torch_infer
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.bin.infer import main as jax_infer
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.utils.checkpoint import save_package as jax_save_package

from test_torch_wave_models import flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W2V_YAML = os.path.join(ROOT, "egs", "wav2vec", "configs", "wav2vec_ctc_test.yaml")
SMALL_WAVE = {"signal": {"feature_type": "wave", "d_model": 16}}
TRAINING = {"batch_time": 20000, "print_inteval": 1, "num_epoch": 1,
            "accumulate_grad_batch": 1, "init_lr": 1e-3, "optimtype": "adam",
            "grad_max_norm": 5.0, "num_last_ckpt_keep": 5, "label_type": "tokens",
            "lr_scheduler": {"type": "warmup_transformer", "warmup_step": 20, "d_model": 32}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("wave_cli"))
    gen_mini_corpus.main(["--out", out, "--wave", "--num_utts", "16"])
    return out


def data_section(corpus):
    return {"trainset": os.path.join(corpus, "train_wav.json"),
            "devset": os.path.join(corpus, "dev_wav.json"),
            "vocab_path": os.path.join(corpus, "train_chars.txt"),
            "feat_range": "400,120000", "label_range": "1,50", "fetchworker_num": 0}


def write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def read_metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """{model type: its exp dir}: wav2vec_ctc through bin/train.py, CPC
    pretraining and the gru_ctc finetune through bin/train_cpc.py."""
    root = tmp_path_factory.mktemp("wave_exps")
    with open(W2V_YAML) as f:
        w2v = yaml.safe_load(f)
    w2v["data"] = data_section(corpus)
    w2v["training"].update(exp_dir=str(root / "w2v"), num_epoch=1, print_inteval=1)
    train.main([write_yaml(root / "w2v.yaml", w2v), "--device", "cpu"])

    cpc = {"data": data_section(corpus),
           "model": {"type": "encoder_cpc", **SMALL_WAVE,
                     "cpc": {"d_input": 16, "d_coding": 8, "n_layers": 1, "n_steps": 3}},
           "training": dict(TRAINING, exp_dir=str(root / "cpc"))}
    train_cpc.main([write_yaml(root / "cpc.yaml", cpc), "--type", "pretrain",
                    "--device", "cpu"])

    gru = {"data": data_section(corpus),
           "model": {"type": "gru_ctc", "add_eos": False, "add_blk": True, **SMALL_WAVE,
                     "encoder": {"d_input": 16, "d_model": 24, "n_layers": 2, "dropout": 0.1},
                     "decoder": {"vocab_size": -1}},
           "training": dict(TRAINING, exp_dir=str(root / "gru"),
                            load_splayer=str(root / "cpc" / "last.pkg"))}
    gru_yaml = write_yaml(root / "gru.yaml", gru)
    train_cpc.main([gru_yaml, "--type", "finetune", "--device", "cpu"])
    return {"wav2vec_ctc": str(root / "w2v"), "encoder_cpc": str(root / "cpc"),
            "gru_ctc": str(root / "gru"), "gru_yaml": gru_yaml}


def test_wav2vec_trains_through_the_train_cli(trained):
    rows = read_metrics(trained["wav2vec_ctc"])
    steps = [r for r in rows if r["phase"] == "train"]
    assert steps and all(np.isfinite(r["ctc_loss"]) for r in steps)
    pkg = load_package(os.path.join(trained["wav2vec_ctc"], "last.pkg"))
    # the stock chain with the freeze gate's counter, one a step
    state = pkg["optim_state"]
    assert state["gate_count"] == state["count"] == pkg["solver_state"]["step"] > 0
    assert "batch_stats" in pkg["model"]


def test_gru_ctc_finetune_keeps_the_pretrained_splayer(trained):
    cpc = load_package(os.path.join(trained["encoder_cpc"], "last.pkg"))["model"]
    rows = read_metrics(trained["encoder_cpc"])
    assert all(np.isfinite(r["cpc_loss"]) for r in rows if r["phase"] == "train")
    gru = load_package(os.path.join(trained["gru_ctc"], "last.pkg"))
    for name, value in flat(cpc["components"]["splayer"]).items():
        np.testing.assert_array_equal(flat(gru["model"]["components"]["splayer"])[name],
                                      value, err_msg=name)
    assert not np.array_equal(gru["model"]["batch_stats"]["splayer"]["bn0"]["mean"],
                              cpc["batch_stats"]["splayer"]["bn0"]["mean"])
    assert not any(k.startswith("splayer.") for k in gru["optim_state"]["mu"])
    steps = gru["solver_state"]["step"]
    # resumed: one more epoch, the splayer still the pretrain package's
    with open(trained["gru_yaml"]) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["num_epoch"] = 2
    path = write_yaml(trained["gru_yaml"] + ".2.yaml", cfg)
    train_cpc.main([path, "--type", "finetune", "--continue-training", "--device", "cpu"])
    after = load_package(os.path.join(trained["gru_ctc"], "last.pkg"))
    assert after["solver_state"]["epoch"] == 2 and after["optim_state"]["count"] > steps
    np.testing.assert_array_equal(after["model"]["components"]["splayer"]["conv3"]["kernel"],
                                  cpc["components"]["splayer"]["conv3"]["kernel"])


def jax_written(pkg_path, out_path):
    """The port's package handed to the JAX package's create_model and
    saved by the JAX package."""
    model_pkg = load_package(pkg_path)["model"]
    variables = {"params": model_pkg["components"], "batch_stats": model_pkg["batch_stats"]}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: copy.deepcopy(variables))
        jax_model = jax_model_class(model_pkg["model_type"]).create_model(
            model_pkg["configs"])
    jax_save_package({"model": jax.tree_util.tree_map(np.asarray, jax_model.package())},
                     out_path)
    return out_path


@pytest.mark.parametrize("model_type,extra", [
    ("gru_ctc", []),
    ("gru_ctc", ["--ctc_beam", "4"]),
    ("wav2vec_ctc", []),
    ("wav2vec_ctc", ["--ctc_beam", "4", "--ctc_beam_device"]),
])
def test_jax_written_package_decodes_alike(trained, corpus, tmp_path, caplog, model_type,
                                           extra):
    pkg = jax_written(os.path.join(trained[model_type], "last.pkg"), str(tmp_path / "jax.pkg"))
    argv = ["--model_type", model_type, "--model_pkg", pkg,
            "--vocab_path", os.path.join(corpus, "train_chars.txt"),
            "--json_file", os.path.join(corpus, "test_wav.json"), "--add_blk",
            "--batch_frames", "200000", "--nbest", "2"] + extra
    caplog.set_level(logging.INFO)
    jax_infer(argv + ["--output", str(tmp_path / "hyp_jax.txt")])
    torch_infer(argv + ["--output", str(tmp_path / "hyp_torch.txt"), "--device", "cpu"])
    hyp_jax = (tmp_path / "hyp_jax.txt").read_text()
    hyp_torch = (tmp_path / "hyp_torch.txt").read_text()
    with open(os.path.join(corpus, "test_wav.json")) as f:
        assert len(hyp_jax.splitlines()) == len(json.load(f)) > 0
    assert hyp_torch == hyp_jax


@pytest.mark.parametrize("model_type", ["gru_ctc", "wav2vec_ctc"])
def test_export_of_the_wave_families_exits_naming_its_item(model_type):
    """They are not exported, as the JAX package cannot export them: the CLI
    says so before it reads anything."""
    from openasr_torch.bin.export_decode import main as export_main

    with pytest.raises(SystemExit, match="cannot export them either"):
        export_main(["--model_type", model_type, "--model_pkg", "unused.pkg",
                     "--vocab_path", "unused.txt", "--out", "unused.zip", "--device", "cpu"])


def test_subword_tokenizer_and_wave_only_collate_match_jax(corpus, tmp_path):
    """`SubwordTokenizer` (and `build_tokenizer`) decode BPE units as the JAX
    package's do, split and unsplit; `WaveOnlyCollate` batches the corpus's
    waves as the JAX package's does."""
    from openasr_torch.data.collate import WaveOnlyCollate
    from openasr_torch.data.tokenizer import build_tokenizer
    from openasr_tpu.data.collate import WaveOnlyCollate as JaxWaveOnlyCollate
    from openasr_tpu.data.tokenizer import build_tokenizer as jax_build_tokenizer

    vocab = tmp_path / "bpe.txt"
    vocab.write_text("hel@@\nlo\nwor@@\nld\n")
    port, ref = (build(str(vocab), add_blk=True, kind="bpe")
                 for build in (build_tokenizer, jax_build_tokenizer))
    ids = port.encode("hel@@ lo wor@@ ld") + [1, 2, 7]
    assert ids == ref.encode("hel@@ lo wor@@ ld") + [1, 2, 7]
    for split in (True, False):
        assert port.decode(ids, split) == ref.decode(ids, split)
    assert port.decode(ids) == "hello world"
    with open(os.path.join(corpus, "dev_wav.json")) as f:
        rows = json.load(f)
    got, want = WaveOnlyCollate()(rows), JaxWaveOnlyCollate()(rows)
    assert got["uttids"] == want["uttids"]
    for key in ("waves", "wave_lengths"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
