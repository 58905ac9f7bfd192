"""The text families (Embed_Decoder, Embed_Decoder_CTC), their data and
solvers, and the rest of the Kaldi IO, against the JAX package on the CPU.

Data: the phone->char datasets (filters, order, `multi`, `sizes`),
`TokenCollate` and `PhoneCharCollate` (add_eos both ways) equal the JAX
package's; every Kaldi writer's output reads back alike through both
packages' readers (matrices, int and float vectors, posteriors, scp and
ark, the alignment and confusion-network aliases).

Models at `tests/test_cpc_text_gan_lm.py`'s p2c widths (d32, one layer,
two heads, dropout 0): the port builds each model from a seed and the JAX
package's create_model takes its package.  Logits (valid rows) and
losses 1e-5, gradients 1e-4, Embed_Decoder's beam n-best equal with
scores 1e-5, Embed_Decoder_CTC's greedy ids equal.  Solvers: 3 steps of
each on the same batches equal the JAX solver's parameters (1e-5), and
the CTC solver's dev pass logs the JAX solver's `dev_wer`.
"""

import io
import json
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_torch.convert import state_dict_to_jax_components
from openasr_torch.data import collate as port_collate
from openasr_torch.data import kaldi_io as port_kaldi
from openasr_torch.data import manifest as port_manifest
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.models.layers import TrainRNG
from openasr_torch.solvers import get_solver_class
from openasr_tpu.data import collate as jax_collate
from openasr_tpu.data import kaldi_io as jax_kaldi
from openasr_tpu.data import manifest as jax_manifest
from openasr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.parallel import make_mesh
from openasr_tpu.solvers import get_solver_class as jax_solver_class

from test_torch_wave_models import close, flat, grads_close

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
PHONES = ["P1", "P2", "P3", "P4"]
CHARS = ["a", "b", "c", "d", "e"]
P2C = {
    "encoder": {"vocab_size": 15, "d_model": 32},
    "decoder": {"type": "TransformerDecoder", "vocab_size": 20, "d_model": 32, "nhead": 2,
                "num_layers": 1, "encoder_dim": 32, "dim_feedforward": 64,
                "activation": "relu", "dropout_rate": 0.0},
}
TRAINING = {"num_epoch": 1, "print_inteval": 1, "accumulate_grad_batch": 1, "init_lr": 1e-3,
            "optimtype": "adam", "grad_max_norm": 5.0, "label_smooth": 0.1,
            "lr_scheduler": {"type": "warmup_transformer", "warmup_step": 20, "d_model": 32}}


def p2c_config(model_type):
    return {"type": model_type, **json.loads(json.dumps(P2C))}


def p2c_batch(seed=0, b=3, p=7, u=5, phone_vocab=15, char_vocab=20):
    rng = np.random.RandomState(seed)
    tlen = np.array([u, u - 2, u - 3][:b])
    return {
        "phones": rng.randint(3, phone_vocab - 1, (b, p)).astype(np.int32),
        "phone_lengths": np.array([p, p - 2, p - 3][:b], np.int32),
        "ids": rng.randint(3, char_vocab - 1, (b, u)).astype(np.int32),
        "labels": rng.randint(3, char_vocab - 1, (b, u)).astype(np.int32),
        "paddings": (np.arange(u)[None, :] >= tlen[:, None]).astype(np.float32),
    }


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def build_pair(cfg, seed=1):
    """(JAX model, port) holding the port's seeded weights."""
    port = get_model_class(cfg["type"]).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, port.package()["components"])}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: params)
        jax_model = jax_model_class(cfg["type"]).create_model(cfg)
    return jax_model, port


def port_grads(port, losses, norm_key, loss_key):
    for p in port.module.parameters():
        p.grad = None
    (losses[loss_key] / losses[norm_key]).backward()
    return flat(state_dict_to_jax_components(
        port.model_type, {n: p.grad for n, p in port.module.named_parameters()},
        port.configs))


# ------------------------------------------------------------------- data

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("text_data")
    rng = np.random.RandomState(0)
    (tmp / "phones.txt").write_text("\n".join(PHONES) + "\n")
    (tmp / "chars.txt").write_text("\n".join(CHARS) + "\n")
    pairs = []
    for i in range(20):
        n_p, n_c = rng.randint(1, 12), rng.randint(1, 6)
        pairs.append({"uttid": f"u{i}", "phones": " ".join(rng.choice(PHONES, n_p)),
                      "phone_length": int(n_p), "tokens": " ".join(rng.choice(CHARS, n_c)),
                      "token_length": int(n_c)})
    (tmp / "pairs.json").write_text(json.dumps(pairs))
    lines = [f"x{i} " + " ".join(rng.choice(PHONES, rng.randint(1, 9))) for i in range(9)]
    (tmp / "phones_unpaired.txt").write_text("\n".join(lines + ["lonely"]) + "\n")
    lines = [f"y{i} " + " ".join(rng.choice(CHARS, rng.randint(1, 9))) for i in range(7)]
    (tmp / "text_unpaired.txt").write_text("\n".join(lines) + "\n")
    return tmp


@pytest.mark.parametrize("kwargs", [{}, {"reverse": True}, {"multi": 2},
                                    {"sort": False, "rate_in_out": (0, 10**9)},
                                    {"feat_range": (3, 8), "label_range": (2, 4)}])
def test_phone_char_dataset_matches_jax(corpus, kwargs):
    path = str(corpus / "pairs.json")
    got = port_manifest.PhoneCharDataset(path, **kwargs)
    want = jax_manifest.PhoneCharDataset(path, **kwargs)
    assert len(got) == len(want) > 0
    assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]


def test_token_lines_and_semi_dataset_match_jax(corpus):
    for name in ("phones_unpaired.txt", "text_unpaired.txt"):
        path = str(corpus / name)
        assert port_manifest.load_token_lines(path) == jax_manifest.load_token_lines(path)
        for multi in (1, 3):
            got = port_manifest.TokenDataset(path, multi)
            want = jax_manifest.TokenDataset(path, multi)
            assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]
    args = [str(corpus / n) for n in ("phones_unpaired.txt", "text_unpaired.txt", "pairs.json")]
    got, want = port_manifest.SemiPhoneCharDataset(*args), jax_manifest.SemiPhoneCharDataset(*args)
    assert got.sizes() == want.sizes() == {"paired": len(want), "phone": 9, "text": 7}
    assert got.data == want.data and got.phone_data == want.phone_data


@pytest.mark.parametrize("add_eos", [True, False])
def test_collates_match_jax(corpus, add_eos):
    tok = {"phone": str(corpus / "phones.txt"), "char": str(corpus / "chars.txt")}
    pc_port = port_collate.PhoneCharCollate(CharTokenizer(tok["phone"]),
                                            CharTokenizer(tok["char"], add_blk=True), add_eos)
    pc_jax = jax_collate.PhoneCharCollate(JaxCharTokenizer(tok["phone"]),
                                          JaxCharTokenizer(tok["char"], add_blk=True), add_eos)
    rows = json.loads((corpus / "pairs.json").read_text())[:6]
    lines = jax_manifest.load_token_lines(str(corpus / "phones_unpaired.txt"))
    for got, want in ((pc_port(rows), pc_jax(rows)),
                      (port_collate.TokenCollate(CharTokenizer(tok["phone"]))(lines),
                       jax_collate.TokenCollate(JaxCharTokenizer(tok["phone"]))(lines))):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v


def _entries(kind, rng):
    if kind == "vec_int":
        return [(f"k{i}", rng.randint(-5, 9, rng.randint(0, 7))) for i in range(4)]
    if kind == "vec_flt":
        dt = [np.float32, np.float64, np.float32, np.float64]
        return [(f"k{i}", rng.randn(rng.randint(0, 7)).astype(dt[i])) for i in range(4)]
    if kind == "post":
        return [(f"k{i}", [[(int(rng.randint(0, 50)), float(np.float32(rng.rand())))
                            for _ in range(rng.randint(0, 4))] for _ in range(rng.randint(0, 5))])
                for i in range(4)]
    return [(f"k{i}", rng.randn(rng.randint(1, 6), 3).astype(np.float32)) for i in range(4)]


WRITERS = {"vec_int": "write_vec_int", "vec_flt": "write_vec_flt", "post": "write_post",
           "mat": "write_mat"}
ARK_READERS = {"vec_int": ("read_vec_int_ark", "read_ali_ark"), "vec_flt": ("read_vec_flt_ark",),
               "post": ("read_post_ark", "read_cnet_ark"), "mat": ("read_mat_ark",)}
ONE_READERS = {"vec_int": "read_vec_int", "vec_flt": "read_vec_flt", "mat": "read_mat"}


def _same(a, b):
    if isinstance(b, list):
        assert a == b
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(WRITERS))
@pytest.mark.parametrize("writer,reader", [(port_kaldi, jax_kaldi), (jax_kaldi, port_kaldi)])
def test_kaldi_io_reads_the_other_packages_writes(tmp_path, kind, writer, reader):
    entries = _entries(kind, np.random.RandomState(len(kind)))
    ark = tmp_path / "x.ark"
    buf = io.BytesIO()
    offsets = [getattr(writer, WRITERS[kind])(buf, v, k) for k, v in entries]
    ark.write_bytes(buf.getvalue())
    for name in ARK_READERS[kind]:
        got = list(getattr(reader, name)(str(ark)))
        assert [k for k, _ in got] == [k for k, _ in entries]
        for (_, a), (_, b) in zip(got, getattr(writer, ARK_READERS[kind][0])(str(ark))):
            _same(a, b)
    if kind in ONE_READERS:
        scp = tmp_path / "x.scp"
        scp.write_text("".join(f"{k} {ark}:{o}\n" for (k, _), o in zip(entries, offsets)))
        for (k, v), o in zip(entries, offsets):
            _same(getattr(reader, ONE_READERS[kind])(f"{ark}:{o}"),
                  getattr(writer, ONE_READERS[kind])(f"{ark}:{o}"))
        scp_reader = {"mat": "read_mat_scp", "vec_flt": "read_vec_flt_scp"}.get(kind)
        if scp_reader:
            for (k, a), (k2, b) in zip(getattr(reader, scp_reader)(str(scp)),
                                       getattr(writer, scp_reader)(str(scp))):
                assert k == k2
                _same(a, b)
    if kind == "vec_int":
        # the text form of an int vector, through a pipe
        text = tmp_path / "t.txt"
        text.write_text("[ 3 4 5 ]\n")
        _same(reader.read_vec_int(f"cat {text} |"), writer.read_vec_int(f"cat {text} |"))


# ------------------------------------------------------------------ models

@pytest.fixture(scope="module")
def pairs():
    return {t: build_pair(p2c_config(t)) for t in ("Embed_Decoder", "Embed_Decoder_CTC")}


def test_embed_decoder_matches_jax(pairs):
    jax_model, port = pairs["Embed_Decoder"]
    batch = p2c_batch(0)

    @jax.jit
    def run(params, batch):
        def f(p):
            out = jax_model.loss(p, batch, {"dropout": jax.random.PRNGKey(0)}, train=True,
                                 label_smooth=0.1)
            return out["ce_loss"] / out["n_tokens"], out

        (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        tlen = jnp.sum(1 - batch["paddings"], -1).astype(jnp.int32)
        logits = jax_model.module.apply({"params": params}, batch["phones"],
                                        batch["phone_lengths"], batch["ids"], tlen)
        return out, grads, logits

    out, grads, logits = run(jax_model.params, batch)
    tb = tensors(batch)
    with torch.no_grad():
        got = port.module(tb["phones"], tb["phone_lengths"], tb["ids"]).numpy()
    valid = batch["paddings"] == 0
    close(got[valid], np.asarray(logits)[valid], LOSS_RTOL, "logits")
    losses = port.loss(tb, TrainRNG(0, "cpu"), label_smooth=0.1)
    close(float(losses["ce_loss"].detach()), float(out["ce_loss"]), LOSS_RTOL, "ce_loss")
    grads_close(port_grads(port, losses, "n_tokens", "ce_loss"),
                flat(jax.tree_util.tree_map(np.asarray, grads)))

    beam = jax.jit(jax_model.batch_beam_decode, static_argnums=(3, 4))
    want = beam(jax_model.params, batch["phones"], batch["phone_lengths"], 3, 8)
    preds, lens, scores = port.batch_beam_decode(tb["phones"], tb["phone_lengths"], 3, 8)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want[1]))
    close(scores.numpy(), want[2], LOSS_RTOL, "beam scores")


def test_embed_decoder_ctc_matches_jax(pairs):
    jax_model, port = pairs["Embed_Decoder_CTC"]
    batch = p2c_batch(1)

    @jax.jit
    def run(params, batch):
        def f(p):
            out = jax_model.loss(p, batch, {"dropout": jax.random.PRNGKey(0)}, train=True)
            return out["ctc_loss"] / out["n_tokens"], out

        (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        logits, _ = jax_model.get_logits(params, batch["phones"], batch["phone_lengths"])
        ids, lens = jax_model.greedy_decode(params, batch["phones"], batch["phone_lengths"])
        return out, grads, logits, ids, lens

    out, grads, logits, ids, lens = run(jax_model.params, batch)
    tb = tensors(batch)
    got_logits, got_lens = port.get_logits(tb["phones"], tb["phone_lengths"])
    close(got_logits.numpy(), logits, LOSS_RTOL, "logits")
    np.testing.assert_array_equal(got_lens.numpy(), batch["phone_lengths"])
    got_ids, got_n = port.greedy_decode(tb["phones"], tb["phone_lengths"])
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(lens))
    for i, n in enumerate(np.asarray(lens)):
        np.testing.assert_array_equal(got_ids.numpy()[i, :n], np.asarray(ids)[i, :n])
    losses = port.loss(tb, TrainRNG(0, "cpu"))
    close(float(losses["ctc_loss"].detach()), float(out["ctc_loss"]), LOSS_RTOL, "ctc_loss")
    assert port.fc_component_names() == ("ctc_fc",)
    assert "affine" not in dict(port.module.encoder_block.named_children())
    grads_close(port_grads(port, losses, "n_tokens", "ctc_loss"),
                flat(jax.tree_util.tree_map(np.asarray, grads)))


def test_embed_decoder_ctc_projects_a_narrower_embedding():
    """encoder.d_model 16 under a d32 stack: the stack's Dense `affine`
    (input_dim from encoder.d_model), bridged both ways."""
    cfg = p2c_config("Embed_Decoder_CTC")
    cfg["encoder"]["d_model"] = 16
    jax_model, port = build_pair(cfg)
    assert tuple(port.module.encoder_block.affine.weight.shape) == (32, 16)
    batch = p2c_batch(2)
    want, _ = jax_model.get_logits(jax_model.params, batch["phones"], batch["phone_lengths"])
    got, _ = port.get_logits(torch.from_numpy(batch["phones"]),
                             torch.from_numpy(batch["phone_lengths"]))
    close(got.numpy(), want, LOSS_RTOL, "logits")


# ----------------------------------------------------------------- solvers

def dev_wers(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [r["dev_wer"] for r in map(json.loads, f) if "dev_wer" in r]


@pytest.mark.parametrize("model_type", ["Embed_Decoder", "Embed_Decoder_CTC"])
def test_solvers_match_jax(pairs, tmp_path, model_type):
    """3 steps on the same batches: parameters 1e-5; the CTC solver's dev
    pass logs the JAX solver's dev WER (the greedy decode of each batch;
    one dev row's labels are the CTC model's own greedy ids, so the WER is
    below 1)."""
    jax_model, port = build_pair(p2c_config(model_type), seed=4)
    batches = [p2c_batch(10 + i) for i in range(3)]
    dev = [p2c_batch(20), p2c_batch(21, b=2)]
    if model_type == "Embed_Decoder_CTC":
        ids, lens = port.greedy_decode(torch.from_numpy(dev[0]["phones"]),
                                       torch.from_numpy(dev[0]["phone_lengths"]))
        n = min(int(lens[0]), dev[0]["labels"].shape[1])
        dev[0]["labels"][0, :n] = ids[0, :n].numpy()
        dev[0]["paddings"][0] = (np.arange(dev[0]["labels"].shape[1]) >= n)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_solver = jax_solver_class(model_type)(
        jax_model, dict(TRAINING, exp_dir=jax_dir), batches, dev,
        mesh=make_mesh(jax.devices("cpu")[:1]))
    jax_solver.iter_one_epoch()
    jax_solver.iter_one_epoch(cross_valid=True)
    solver = get_solver_class(model_type)(port, dict(TRAINING, exp_dir=port_dir), batches, dev,
                                          device="cpu")
    assert type(solver).__name__ == type(jax_solver).__name__
    solver.iter_one_epoch()
    solver.iter_one_epoch(cross_valid=True)
    assert solver.step == jax_solver.step == 3
    want = flat(jax.tree_util.tree_map(np.asarray, jax_solver.model.params))
    for name, value in flat(port.package()["components"]).items():
        close(value, want[name], PARAM_TOL, name)
    if model_type == "Embed_Decoder_CTC":
        got, want = dev_wers(port_dir), dev_wers(jax_dir)
        assert len(got) == len(want) == 1 and 0.0 <= want[0] < 1.0
        assert abs(got[0] - want[0]) <= 1e-12
    else:
        assert dev_wers(port_dir) == dev_wers(jax_dir) == []
