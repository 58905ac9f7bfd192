"""The port's CLIs on the CIF family against the JAX package, on the CPU.

The milestones, on the mini corpus of `openasr_torch.bin.gen_mini_corpus`
(16 utterances, 20-dim features, 4 chars and 4 phones) and
egs/aishell1/configs/cif_test.yaml:

- decode: from one package that the JAX package saved, the port's infer
  CLI writes the JAX CLI's hyp file, with and without a hotword file
  (n-best scores within 1e-3);
- training: the port's train CLI runs the config's 2 epochs; the JAX model
  restores the package it wrote and its dev loss (the CE over tokens, on
  the same dev batches) equals the port's logged dev loss to 1e-3;
- CIF_MIX's epoch makes one optimizer step per (acoustic, paired) pair,
  over the sum of both batches' gradients (SGD, so the update is linear in
  them), and steps a leftover at the epoch's end;
- CIF_FC and CIF_MIX (callhome_hkust's cif_fc_test.yaml and
  cif_mix_test.yaml, CIF_MIX with its acoustic loader) train through the
  CLI with finite losses.
"""

import copy
import json
import logging
import os
import re

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openasr_torch.bin import train as port_train
from openasr_torch.bin.gen_mini_corpus import main as gen_mini_corpus
from openasr_torch.utils.checkpoint import load_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIF_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "cif_test.yaml")
HKUST = os.path.join(ROOT, "egs", "callhome_hkust", "configs")
RTOL = 1e-3
SCORE_TOL = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cif_corpus"))
    gen_mini_corpus(["--out", out])
    with open(os.path.join(out, "hot.txt"), "w") as f:
        f.write("a b\nc d c\n")
    return out


def write_config(corpus, yaml_path, exp_dir, path, **training):
    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    for key, name in (("trainset", "train.json"), ("devset", "dev.json"),
                      ("acousticset", "train.json")):
        if key in cfg["data"]:
            cfg["data"][key] = os.path.join(corpus, name)
    for key in ("vocab_path", "vocab_phone"):
        if key in cfg["data"]:
            cfg["data"][key] = os.path.join(corpus, os.path.basename(cfg["data"][key]))
    cfg["training"].update(exp_dir=str(exp_dir), print_inteval=1, **training)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


def read_metrics(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_model_of(model_cfg, components):
    """The JAX model of `model_cfg` holding `components` (flax's eager init
    skipped)."""
    from openasr_tpu.models import get_model_class as jax_model_class

    params = jax.tree_util.tree_map(jnp.asarray, components)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return jax_model_class(model_cfg["type"]).create_model(model_cfg)


@pytest.fixture(scope="module")
def jax_package(corpus, tmp_path_factory):
    """cif_test.yaml's model at the corpus's vocabulary, drawn by the port
    and saved by the JAX package's save_package."""
    from openasr_tpu.utils.checkpoint import save_package as jax_save_package
    from openasr_torch.data.tokenizer import CharTokenizer
    from openasr_torch.models import get_model_class

    with open(CIF_YAML) as f:
        model_cfg = yaml.safe_load(f)["model"]
    model_cfg["decoder"]["vocab_size"] = CharTokenizer(
        os.path.join(corpus, "chars.txt")).unit_num()
    port = get_model_class("CIF").create_model(
        model_cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    path = str(tmp_path_factory.mktemp("cif_pkg") / "cif.pkg")
    jax_save_package(jax_model_of(model_cfg, port.package()["components"]).package(), path)
    return path


@pytest.mark.parametrize("hotwords", [False, True])
def test_port_infer_cli_writes_the_jax_cli_hyp_file(corpus, jax_package, tmp_path, caplog,
                                                    hotwords):
    from openasr_tpu.bin.infer import main as jax_infer
    from openasr_torch.bin.infer import main as torch_infer

    def argv(out):
        return (["--model_type", "CIF", "--model_pkg", jax_package,
                 "--vocab_path", os.path.join(corpus, "chars.txt"),
                 "--json_file", os.path.join(corpus, "test.json"), "--output", str(out),
                 "--offline", "--nbest", "3", "--maxlen", "8", "--batch_frames", "300"]
                + (["--context_file", os.path.join(corpus, "hot.txt")] if hotwords else []))

    caplog.set_level(logging.INFO)
    jax_infer(argv(tmp_path / "hyp_jax.txt"))
    jax_log = caplog.text
    caplog.clear()
    torch_infer(argv(tmp_path / "hyp_torch.txt") + ["--device", "cpu"])
    torch_log = caplog.text
    want = (tmp_path / "hyp_jax.txt").read_text()
    assert len(want.splitlines()) == 8
    assert (tmp_path / "hyp_torch.txt").read_text() == want
    s_jax, s_torch = (np.array([float(s) for s in re.findall(r"score: (-?[0-9.]+)", t)])
                      for t in (jax_log, torch_log))
    assert len(s_jax) == len(s_torch) == 24
    assert np.abs(s_jax - s_torch).max() <= SCORE_TOL


def test_train_cli_dev_loss_matches_the_jax_package(corpus, tmp_path):
    from openasr_tpu.data.collate import FeatureCollate
    from openasr_tpu.data.loader import DataLoader
    from openasr_tpu.data.manifest import ArkDataset
    from openasr_tpu.data.sampler import FrameBasedSampler
    from openasr_tpu.data.tokenizer import CharTokenizer

    exp = tmp_path / "exp"
    cfg = write_config(corpus, CIF_YAML, exp, tmp_path / "cif.yaml")
    port_train.main([str(tmp_path / "cif.yaml"), "--device", "cpu"])
    rows = read_metrics(exp)
    epochs = [r for r in rows if r["phase"] == "epoch"]
    assert len(epochs) == 2 and all(np.isfinite(r["cv_loss"]) for r in epochs)
    assert sum(r["phase"] == "train" for r in rows) >= 4
    pkg = load_package(str(exp / "last.pkg"))
    assert pkg["solver_state"]["step"] == epochs[-1]["step"]

    model_cfg = copy.deepcopy(pkg["model"]["configs"])
    jax_model = jax_model_of(model_cfg, pkg["model"]["components"])
    jax_model.restore(pkg["model"])
    tokenizer = CharTokenizer(cfg["data"]["vocab_path"])
    dev = ArkDataset(cfg["data"]["devset"], reverse=True)
    loader = DataLoader(dev, FrameBasedSampler(dev, cfg["training"]["batch_frames"], 1),
                        FeatureCollate(tokenizer, False, "tokens"), num_workers=0)
    loss_fn = jax.jit(lambda p, b: jax_model.loss(p, b, {}, train=False,
                                                  label_smooth=cfg["training"]["label_smooth"]))
    ce = tokens = 0.0
    for batch in loader:
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        losses = loss_fn(jax_model.params, arrays)
        ce += float(losses["ce_loss"])
        tokens += float(losses["n_tokens"])
    want = ce / tokens
    assert abs(epochs[-1]["cv_loss"] - want) <= RTOL * abs(want), (epochs[-1], want)


def _mix_batches(rng, n_ac):
    def feats(b, t):
        return {"feats": rng.randn(b, t, 20).astype(np.float32),
                "feat_lengths": np.array([t, t - 4], np.int32),
                "phones": rng.randint(3, 7, (b, 5)).astype(np.int32),
                "phone_lengths": np.array([5, 4], np.int32)}

    acoustic = [feats(2, 24) for _ in range(n_ac)]
    paired = dict(feats(2, 28), ids=rng.randint(3, 7, (2, 4)).astype(np.int32),
                  labels=rng.randint(3, 7, (2, 4)).astype(np.int32),
                  paddings=np.zeros((2, 4), np.float32))
    return acoustic, [paired]


@pytest.mark.parametrize("n_acoustic,accumulate,steps", [(1, 1, 1), (3, 2, 2)])
def test_cif_mix_makes_one_step_per_pair(tmp_path, n_acoustic, accumulate, steps):
    """SGD at lr = init_lr * schedule(1): after one pair the weights are
    the initial ones minus lr times the sum of the pair's two gradients
    (each batch drawn with the seed the solver gives it); 3 pairs
    accumulated by 2 make 2 steps, the last a leftover."""
    from openasr_torch.models import get_model_class
    from openasr_torch.models.layers import TrainRNG
    from openasr_torch.solvers import get_solver_class, batch_to_device

    with open(os.path.join(HKUST, "cif_mix_test.yaml")) as f:
        cfg = yaml.safe_load(f)
    model_cfg = cfg["model"]
    model_cfg["decoder"]["vocab_size"], model_cfg["phone_size"] = 8, 9
    training = dict(cfg["training"], exp_dir=str(tmp_path / "exp"), optimtype="sgd",
                    grad_max_norm=0.0, print_inteval=1000, init_lr=1e-2,
                    accumulate_grad_batch=accumulate, num_epoch=1)
    acoustic, paired = _mix_batches(np.random.RandomState(3), n_acoustic)

    def fresh():
        model = get_model_class("CIF_MIX").create_model(
            model_cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        solver = get_solver_class("CIF_MIX")(model, training, paired, paired,
                                             acoustic_loader=acoustic, device="cpu")
        return model, solver

    model, solver = fresh()
    solver.iter_one_epoch()
    assert solver.step == steps and solver.optimizer.state_dict()["count"] == steps
    if n_acoustic > 1:
        return
    ref, ref_solver = fresh()
    rng = TrainRNG(0, "cpu")
    for j, batch in enumerate((acoustic[0], paired[0])):
        rng.reseed((0 << 32) + 0 * 8191 + 2 * 1 + j)
        losses = ref.loss(batch_to_device(batch, torch.device("cpu")), rng,
                          label_smooth=training["label_smooth"])
        ref_solver.mix_losses(losses).backward()
    lr = ref_solver.current_lr()
    with torch.no_grad():
        for (name, p), q in zip(ref.module.named_parameters(), model.module.parameters()):
            want = p - lr * (p.grad if p.grad is not None else 0.0)
            assert torch.allclose(q, want, atol=1e-7, rtol=1e-6), name


@pytest.mark.parametrize("yaml_name", ["cif_fc_test.yaml", "cif_mix_test.yaml"])
def test_phone_families_train_through_the_cli(corpus, tmp_path, yaml_name):
    exp = tmp_path / "exp"
    write_config(corpus, os.path.join(HKUST, yaml_name), exp, tmp_path / "c.yaml",
                 num_epoch=1)
    port_train.main([str(tmp_path / "c.yaml"), "--device", "cpu"])
    rows = read_metrics(exp)
    train = [r for r in rows if r["phase"] == "train"]
    losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
    assert train and losses and all(np.isfinite(v) for v in losses)
    keys = {"ctc_loss", "qua_loss", "ce_loss"}
    if yaml_name.startswith("cif_mix"):
        keys.add("ce_char_loss")
    assert keys <= set(train[-1])
    pkg = load_package(str(exp / "last.pkg"))
    assert pkg["optim_state"]["count"] == train[-1]["step"] == len(train)
