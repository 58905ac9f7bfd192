"""The phone2char CLIs of the port against the JAX package's, on the CPU.

One seeded phone->char corpus serves the file: 24 train and 6 dev pairs
of 12 phones and 2-4 characters (batches of 6, one padded shape, so that
the JAX CLIs compile each step once), 6 test pairs of 9-16 phones, and
unpaired lines of 9-16 phones and 5-8 characters.  The JAX CLIs run in
this process on a one-device mesh (pytest's 8 virtual devices would make
them pack 8-way data-parallel batches).

- `train_phone2char` (JAX) writes an Embed_Decoder_CTC package at
  `phone2char_test.yaml`'s widths and an Embed_Decoder one at the same;
  `infer_phone2char` of the port decodes each package as the JAX CLI
  does: hyp.txt and ref.txt equal, the same `WER:` line.
- `train_phone2char --continue-training` of the port continues each
  JAX-written package one epoch, and equals the JAX CLI continuing it:
  parameters 1e-5, the dev WER of the CTC model equal.  The attention key
  biases, whose gradient is 0 but for rounding, are held to the moves
  Adam makes of that noise (at most twice the summed learning rates).
- `semi_train_phone2char` of the port reads the JAX CTC package through
  `training.G_path` (at init_lr 0 its G stays that package) and continues
  a package the JAX semi CLI wrote, one more epoch with its dev WER.  The
  JAX GAN's dev pass calls a `greedy_decode` it lacks; the test lends it
  the Embed_Decoder_CTC one, as the port's GAN has (ROADMAP queue 3).
"""

import contextlib
import io
import json
import shutil

import jax
import numpy as np
import pytest
import yaml

from openasr_torch.bin import infer_phone2char, semi_train_phone2char, train_phone2char
from openasr_torch.ops.schedules import get_schedule
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.bin import infer_phone2char as jax_infer
from openasr_tpu.bin import semi_train_phone2char as jax_semi
from openasr_tpu.bin import train_phone2char as jax_train
from openasr_tpu.models.gan import GANPhone2Char as JaxGAN
from openasr_tpu.parallel import make_mesh

from test_torch_gan import _jax_greedy
from test_torch_wave_models import close, flat

PARAM_TOL = 1e-5
PHONES = [f"p{i}" for i in range(12)]
CHARS = [f"c{i}" for i in range(9)]
TEST_YAML = "egs/IPA2char/configs/phone2char_test.yaml"


def _pairs(rng, n, prefix, phones=(12, 12)):
    rows = []
    for i in range(n):
        n_c = rng.randint(2, 5)
        n_p = rng.randint(phones[0], phones[1] + 1)
        rows.append({"uttid": f"{prefix}{i:02d}", "phones": " ".join(rng.choice(PHONES, n_p)),
                     "phone_length": int(n_p), "tokens": " ".join(rng.choice(CHARS, n_c)),
                     "token_length": int(n_c)})
    return rows


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p2c_cli")
    rng = np.random.RandomState(7)
    (tmp / "phones.txt").write_text("\n".join(PHONES) + "\n")
    (tmp / "chars.txt").write_text("\n".join(CHARS) + "\n")
    for name, n, phones in (("train", 24, (12, 12)), ("dev", 6, (12, 12)),
                            ("test", 6, (9, 16))):
        (tmp / f"{name}.json").write_text(json.dumps(_pairs(rng, n, name, phones)))
    (tmp / "phones_unpaired.txt").write_text("".join(
        f"x{i} {' '.join(rng.choice(PHONES, rng.randint(9, 17)))}\n" for i in range(32)))
    (tmp / "text_unpaired.txt").write_text("".join(
        f"y{i} {' '.join(rng.choice(CHARS, rng.randint(5, 9)))}\n" for i in range(32)))
    return tmp


@pytest.fixture
def one_device(monkeypatch):
    mesh = make_mesh(jax.devices("cpu")[:1])
    for module in (jax_train, jax_semi):
        monkeypatch.setattr(module, "make_mesh", lambda: mesh)
    monkeypatch.setattr(JaxGAN, "greedy_decode", _jax_greedy, raising=False)


def p2c_yaml(corpus, exp, model_type, path, num_epoch=1):
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=str(corpus / "train.json"), devset=str(corpus / "dev.json"),
                       vocab_phone=str(corpus / "phones.txt"),
                       vocab_char=str(corpus / "chars.txt"))
    cfg["training"].update(exp_dir=str(exp), num_epoch=num_epoch, print_inteval=1)
    if model_type == "Embed_Decoder":
        cfg["model"].update(type=model_type, add_eos=True, add_blk=False)
        cfg["model"]["decoder"].update(type="TransformerDecoder", encoder_dim=32)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def semi_yaml(corpus, exp, path, num_epoch=1, **training):
    with open(TEST_YAML) as f:
        base = yaml.safe_load(f)
    g = {"encoder": base["model"]["encoder"], "decoder": base["model"]["decoder"]}
    cfg = {"data": dict(base["data"], trainset=str(corpus / "train.json"),
                        devset=str(corpus / "dev.json"),
                        unpaired_phone=str(corpus / "phones_unpaired.txt"),
                        unpaired_text=str(corpus / "text_unpaired.txt"),
                        vocab_phone=str(corpus / "phones.txt"),
                        vocab_char=str(corpus / "chars.txt")),
           "model": {"type": "gan_phone2char", "add_blk": True, "G": g,
                     "D": {"encoder": {"d_input": -1, "d_model": 32, "layer_num": 2}}},
           "training": dict(base["training"], exp_dir=str(exp), num_epoch=num_epoch,
                            print_inteval=1, unpaired_batch_size=8, **training)}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def jax_packages(corpus, tmp_path_factory):
    """The JAX train CLI's packages, one epoch of each text model."""
    tmp = tmp_path_factory.mktemp("jax_p2c")
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_train, "make_mesh", lambda: make_mesh(jax.devices("cpu")[:1]))
        for model_type in ("Embed_Decoder_CTC", "Embed_Decoder"):
            exp = tmp / model_type
            jax_train.main([p2c_yaml(corpus, exp, model_type, tmp / f"{model_type}.yaml")])
            out[model_type] = exp
    return out


def _infer(main, corpus, pkg, model_type, out_dir, extra=()):
    argv = ["--model_type", model_type, "--model_pkg", str(pkg),
            "--vocab_phone", str(corpus / "phones.txt"), "--vocab_char", str(corpus / "chars.txt"),
            "--json_file", str(corpus / "test.json"), "--output_dir", str(out_dir),
            "--batch_phones", "200", "--nbest", "3", "--maxlen", "8"]
    if model_type == "Embed_Decoder_CTC":
        argv.append("--add_blk")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        main(argv + list(extra))
    return stdout.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("model_type", ["Embed_Decoder_CTC", "Embed_Decoder"])
def test_infer_phone2char_decodes_a_jax_package_as_the_jax_cli(corpus, jax_packages, tmp_path,
                                                               model_type):
    pkg = jax_packages[model_type] / "last.pkg"
    want = _infer(jax_infer.main, corpus, pkg, model_type, tmp_path / "jax")
    got = _infer(infer_phone2char.main, corpus, pkg, model_type, tmp_path / "port",
                 ["--device", "cpu"])
    assert got == want and got.startswith("WER: ")
    for name in ("hyp.txt", "ref.txt"):
        lines = (tmp_path / "port" / name).read_text().splitlines()
        assert lines == (tmp_path / "jax" / name).read_text().splitlines()
        assert len(lines) == 6


def jax_packages_steps(exp):
    return load_package(str(exp / "last.pkg"))["solver_state"]["step"]


def _dev_wers(exp):
    with open(exp / "metrics.jsonl") as f:
        return [r["dev_wer"] for r in map(json.loads, f) if "dev_wer" in r]


@pytest.mark.parametrize("model_type", ["Embed_Decoder_CTC", "Embed_Decoder"])
def test_train_phone2char_continues_a_jax_package(corpus, jax_packages, tmp_path, one_device,
                                                  model_type):
    runs = {}
    for tag, main, extra in (("jax", jax_train.main, []),
                             ("port", train_phone2char.main, ["--device", "cpu"])):
        exp = tmp_path / tag
        shutil.copytree(jax_packages[model_type], exp)
        main([p2c_yaml(corpus, exp, model_type, tmp_path / f"{tag}.yaml", num_epoch=2),
              "--continue-training"] + extra)
        runs[tag] = load_package(str(exp / "last.pkg"))
    assert runs["port"]["solver_state"]["epoch"] == runs["jax"]["solver_state"]["epoch"] == 2
    assert runs["port"]["solver_state"]["step"] == runs["jax"]["solver_state"]["step"]
    # an attention's key bias has a zero gradient (softmax is invariant to
    # a score shift per query row): Adam turns its rounding noise into
    # moves of up to about lr a step, in either direction in either run
    cfg = runs["port"]["solver_config"]
    steps = range(jax_packages_steps(jax_packages[model_type]) + 1,
                  runs["port"]["solver_state"]["step"] + 1)
    noise = 2 * sum(float(cfg["init_lr"]) * get_schedule(cfg["lr_scheduler"])(s) for s in steps)
    want = flat(runs["jax"]["model"]["components"])
    for name, value in flat(runs["port"]["model"]["components"]).items():
        if name.endswith("/k/bias"):
            assert float(np.abs(value - want[name]).max()) <= noise, name
        else:
            close(value, want[name], PARAM_TOL, name)
    got, want = _dev_wers(tmp_path / "port"), _dev_wers(tmp_path / "jax")
    assert len(got) == len(want) == (2 if model_type == "Embed_Decoder_CTC" else 0)
    assert got == pytest.approx(want, abs=1e-12)


def test_semi_train_phone2char_reads_g_path_and_continues_a_jax_package(
        corpus, jax_packages, tmp_path, one_device):
    g_path = str(jax_packages["Embed_Decoder_CTC"] / "last.pkg")
    exp = tmp_path / "still"
    semi_train_phone2char.main([semi_yaml(corpus, exp, tmp_path / "still.yaml", init_lr=0.0,
                                          G_path=g_path), "--device", "cpu"])
    got = load_package(str(exp / "last.pkg"))["model"]["components"]["G"]
    want = flat(load_package(g_path)["model"]["components"])
    for name, value in flat(got).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)

    exp = tmp_path / "semi"
    jax_semi.main([semi_yaml(corpus, exp, tmp_path / "jax.yaml", G_path=g_path)])
    first = load_package(str(exp / "last.pkg"))["solver_state"]
    semi_train_phone2char.main([semi_yaml(corpus, exp, tmp_path / "port.yaml", num_epoch=2,
                                          G_path=g_path), "--continue-training",
                                "--device", "cpu"])
    state = load_package(str(exp / "last.pkg"))["solver_state"]
    assert state["epoch"] == 2 and first["step"] > 0 and state["step"] == 2 * first["step"]
    wers = _dev_wers(exp)
    assert len(wers) == 2 and all(0.0 <= w for w in wers)
    assert np.isfinite(state["tr_loss"]).all() and np.isfinite(state["cv_loss"]).all()
