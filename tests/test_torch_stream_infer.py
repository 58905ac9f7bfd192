"""The port's streaming CLI against the JAX package's, on the CPU.

From one streaming conv-ctc-transformer package (d32, chunk 4, left 1,
offline features) and one Transformer LM package, both saved by the JAX
package, `openasr_torch.bin.stream_infer --device cpu` writes the JAX
CLI's hyp file, line for line: greedy partials, prefix-beam partials
with LM fusion and hotwords (`--partial_beam 4`), and the attention
rescore (`--rescore`).  The CLI's exits (fusion or biasing without
`--partial_beam`, a model without a CTC head and no `--rescore`) are the
JAX CLI's, word for word.  The same package also decodes in one pass
through the port's infer CLI (the batch forward in chunk mode), whose
attention-beam hypotheses equal the stream CLI's rescore.
"""

import contextlib
import json

import flax.linen as flax_nn
import jax
import numpy as np
import pytest

from openasr_torch.data.kaldi_io import write_ark_scp

from test_torch_streaming import pair, speech_config

CHARS = [f"c{i}" for i in range(4)]


@contextlib.contextmanager
def jitted_flax_init():
    """flax's own init, jitted, for the JAX CLI's models (eager, it compiles
    op by op)."""
    init = flax_nn.Module.init
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, rngs, *a: jax.jit(
            lambda r, *x: init(self, r, *x))(rngs, *a))
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six utterances of seeded features, the JAX-saved packages, a
    hotword file."""
    from openasr_tpu.utils.checkpoint import save_package as jax_save_package

    d = tmp_path_factory.mktemp("stream_infer")
    rng = np.random.RandomState(21)
    (d / "chars.txt").write_text("".join(c + "\n" for c in CHARS))
    feats = {f"utt{i}": (rng.randn(int(n), 20) * 0.5).astype(np.float32)
             for i, n in enumerate(rng.randint(30, 75, size=6))}
    write_ark_scp(str(d / "feats"), feats.items())
    rows = []
    for line in (d / "feats.scp").read_text().splitlines():
        utt, path = line.split()
        rows.append({"uttid": utt, "feat": path, "feat_length": feats[utt].shape[0],
                     "tokens": " ".join(rng.choice(CHARS, size=3)), "token_length": 3})
    (d / "test.json").write_text(json.dumps(rows))
    am = speech_config({"chunk": 4, "left_chunks": 1}, model_type="conv-ctc-transformer",
                       sub="ConvV2", activation="glu")
    jax_save_package(pair(am, 11)[1].package(), str(d / "am.pkg"))
    attention_only = dict(am, type="conv-transformer")
    jax_save_package(pair(attention_only, 12)[1].package(), str(d / "att.pkg"))
    lm = {"type": "transformer_lm", "vocab_size": 8, "d_model": 16, "nhead": 2,
          "num_layers": 1, "dim_feedforward": 32, "dropout_rate": 0.0}
    jax_save_package(pair(lm, 13)[1].package(), str(d / "lm.pkg"))
    (d / "hot.txt").write_text("c1 c2\nc3 c3\n")
    return d


def argv(d, out, *extra, model_type="conv-ctc-transformer", pkg="am.pkg"):
    return ["--model_type", model_type, "--model_pkg", str(d / pkg),
            "--vocab_path", str(d / "chars.txt"), "--json_file", str(d / "test.json"),
            "--output", str(d / out), "--offline", "--add_blk", "--batch_size", "4",
            *extra]


MODES = {
    "greedy": ["--show_partials"],
    "beam_lm_hotwords": ["--partial_beam", "4", "--lm_pkg", "LM", "--lm_weight", "0.5",
                         "--context_file", "HOT", "--context_weight", "1.5"],
    "rescore": ["--rescore", "--nbest", "3", "--maxlen", "8"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_cli_writes_the_jax_cli_hyp_file(corpus, mode):
    from openasr_tpu.bin.stream_infer import main as jax_stream
    from openasr_torch.bin.stream_infer import main as torch_stream

    extra = [str(corpus / "lm.pkg") if a == "LM" else str(corpus / "hot.txt") if a == "HOT"
             else a for a in MODES[mode]]
    with jitted_flax_init():
        jax_stream(argv(corpus, f"{mode}_jax.txt", *extra))
    torch_stream(argv(corpus, f"{mode}_torch.txt", *extra, "--device", "cpu"))
    want = (corpus / f"{mode}_jax.txt").read_text()
    assert len(want.splitlines()) == 6
    assert (corpus / f"{mode}_torch.txt").read_text() == want


def test_port_cli_exits_as_the_jax_cli(corpus):
    from openasr_tpu.bin.stream_infer import main as jax_stream
    from openasr_torch.bin.stream_infer import main as torch_stream

    cases = (
        (["--lm_pkg", str(corpus / "lm.pkg"), "--lm_weight", "0.5"], {}),
        (["--context_file", str(corpus / "hot.txt")], {}),
        ([], {"model_type": "conv-transformer", "pkg": "att.pkg"}),
    )
    for extra, kw in cases:
        with pytest.raises(SystemExit) as jax_exit, jitted_flax_init():
            jax_stream(argv(corpus, "unused.txt", *extra, **kw))
        with pytest.raises(SystemExit) as port_exit:
            torch_stream(argv(corpus, "unused.txt", *extra, "--device", "cpu", **kw))
        assert str(port_exit.value) == str(jax_exit.value) != ""


def test_streaming_package_decodes_in_one_pass(corpus):
    """The infer CLI decodes the streaming package in one pass, through the
    batch forward in chunk mode: its attention-beam hypotheses equal the
    stream CLI's rescore of the streamed encoder states (the two-pass
    recipe's exactness, tests/test_streaming.py's check)."""
    from openasr_torch.bin.infer import main as torch_infer

    def hyps(name):
        return dict(line.split(" ", 1) if " " in line else (line, "")
                    for line in (corpus / name).read_text().splitlines())

    if not (corpus / "rescore_torch.txt").exists():
        from openasr_torch.bin.stream_infer import main as torch_stream

        torch_stream(argv(corpus, "rescore_torch.txt", *MODES["rescore"], "--device", "cpu"))
    torch_infer(["--model_type", "conv-ctc-transformer", "--model_pkg", str(corpus / "am.pkg"),
                 "--vocab_path", str(corpus / "chars.txt"), "--json_file",
                 str(corpus / "test.json"), "--output", str(corpus / "batch.txt"), "--offline",
                 "--add_blk", "--nbest", "3", "--maxlen", "8", "--device", "cpu"])
    assert len(hyps("batch.txt")) == 6
    assert hyps("batch.txt") == hyps("rescore_torch.txt")
