"""The port's train CLI against the JAX package's, on the CPU.

The milestone: egs/aishell1/configs/conv-ctc-transformer-test.yaml trained
by both CLIs for its 2 epochs on the tools/gen_mini_corpus.py corpus, from
one initial package that the port writes (the JAX CLI reads it as its own).  Every logged value (the
running train losses after each step, the dev losses, the epoch summaries)
agrees to 1e-3 relative, at the same step and batch numbers, so the batch
order is the same.  The JAX CLI runs in a subprocess on ONE CPU device:
under pytest's 8 virtual devices it would build an 8-way data mesh and
pack other batches.
"""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from openasr_torch.bin import train as port_train
from openasr_torch.utils.checkpoint import load_package, save_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-test.yaml")
RTOL = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import gen_mini_corpus
    finally:
        sys.path.pop(0)
    out = str(tmp_path_factory.mktemp("mini_corpus"))
    gen_mini_corpus.main(["--out", out])
    return out


def write_config(corpus, exp_dir, path, **training):
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=os.path.join(corpus, "train.json"),
                       devset=os.path.join(corpus, "dev.json"),
                       vocab_path=os.path.join(corpus, "chars.txt"))
    cfg["training"].update(exp_dir=str(exp_dir), print_inteval=1, **training)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


def read_metrics(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def initial_package(cfg, exp_dirs):
    """A port model from a fixed seed, as `last.pkg` at step 0 in every exp
    dir (so both CLIs start from it with --continue-training)."""
    from openasr_torch.data.tokenizer import CharTokenizer
    from openasr_torch.models import get_model_class

    model_cfg = copy.deepcopy(cfg["model"])
    model_cfg["decoder"]["vocab_size"] = CharTokenizer(
        cfg["data"]["vocab_path"], add_blk=True).unit_num()
    model = get_model_class(model_cfg["type"]).create_model(
        model_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pkg = {"model": model.package(), "optim_state": None,
           "solver_state": {"epoch": 0, "step": 0, "tr_loss": [], "cv_loss": []}}
    for d in exp_dirs:
        os.makedirs(d, exist_ok=True)
        save_package(pkg, os.path.join(d, "last.pkg"))


def test_milestone_losses_match_the_jax_cli(corpus, tmp_path):
    exp_j, exp_t = tmp_path / "exp_jax", tmp_path / "exp_torch"
    cfg = write_config(corpus, exp_j, tmp_path / "jax.yaml")
    write_config(corpus, exp_t, tmp_path / "torch.yaml")
    initial_package(cfg, (exp_j, exp_t))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    run = subprocess.run(
        [sys.executable, "-m", "openasr_tpu.bin.train", str(tmp_path / "jax.yaml"),
         "--continue-training"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=600,
    )
    assert run.returncode == 0, run.stdout[-3000:]
    port_train.main([str(tmp_path / "torch.yaml"), "--continue-training",
                     "--device", "cpu"])
    want, got = read_metrics(exp_j), read_metrics(exp_t)
    assert len(got) == len(want) and len(want) >= 10
    assert [r["phase"] for r in got] == [r["phase"] for r in want]
    assert sum(r["phase"] == "train" for r in want) >= 8      # 2 epochs of steps
    for a, b in zip(want, got):
        for key in ("epoch", "step", "batch"):
            assert a.get(key) == b.get(key), (a, b)
        if "lr" in a:
            assert abs(a["lr"] - b["lr"]) <= 1e-6 * a["lr"]
        for key, value in a.items():
            if key.endswith("loss"):
                assert abs(b[key] - value) <= RTOL * abs(value), (key, a, b)
    for name in ("ep-0001.pkg", "ep-0002.pkg", "last.pkg"):
        assert (exp_t / name).exists()
    last = load_package(str(exp_t / "last.pkg"))
    assert last["solver_state"]["step"] == want[-1]["step"]


def test_continue_training_resumes_at_the_saved_step(corpus, tmp_path):
    exp = tmp_path / "exp"
    write_config(corpus, exp, tmp_path / "one.yaml", num_epoch=1)
    port_train.main([str(tmp_path / "one.yaml"), "--device", "cpu"])
    first = read_metrics(exp)
    saved = load_package(str(exp / "last.pkg"))
    steps = saved["solver_state"]["step"]
    assert saved["solver_state"]["epoch"] == 1 and steps == first[-1]["step"] > 0
    assert saved["optim_state"]["count"] == steps

    write_config(corpus, exp, tmp_path / "two.yaml", num_epoch=2)
    port_train.main([str(tmp_path / "two.yaml"), "--continue-training", "--device", "cpu"])
    resumed = read_metrics(exp)[len(first):]
    train_rows = [r for r in resumed if r["phase"] == "train"]
    assert train_rows[0]["step"] == steps + 1 and train_rows[0]["epoch"] == 2
    assert resumed[-1]["phase"] == "epoch" and resumed[-1]["step"] == 2 * steps
    final = load_package(str(exp / "last.pkg"))
    assert final["solver_state"]["epoch"] == 2
    assert final["optim_state"]["count"] == 2 * steps
    assert sorted(p.name for p in exp.glob("ep-*.pkg")) == ["ep-0001.pkg", "ep-0002.pkg"]


def test_bfloat16_compute_trains_with_finite_losses(corpus, tmp_path):
    exp = tmp_path / "exp"
    write_config(corpus, exp, tmp_path / "bf16.yaml", num_epoch=1,
                 compute_dtype="bfloat16")
    port_train.main([str(tmp_path / "bf16.yaml"), "--device", "cpu"])
    rows = read_metrics(exp)
    losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
    assert losses and all(v == v and abs(v) < 1e30 for v in losses)
    pkg = load_package(str(exp / "last.pkg"))
    assert pkg["optim_state"]["count"] == rows[-1]["step"] > 0
    comps = pkg["model"]["components"]
    leaves = [v for c in comps.values() for v in _leaves(c)]
    assert leaves and all(v.dtype == "float32" and (abs(v) < 1e30).all() for v in leaves)


def test_ctc_solver_logs_a_dev_sample_decode(corpus, tmp_path, caplog):
    """conv-ctc (the test config's encoder with a CTC head): the dev pass
    logs the greedy ids of its first utterance."""
    cfg_path = tmp_path / "ctc.yaml"
    cfg = write_config(corpus, tmp_path / "exp", cfg_path, num_epoch=1)
    cfg["model"]["type"] = "conv-ctc"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    caplog.set_level("INFO")
    port_train.main([str(cfg_path), "--device", "cpu"])
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("dev sample greedy ids: [")]
    assert len(lines) == 1
    ids = json.loads(lines[0].split(": ", 1)[1])
    # 3 specials + 4 characters + blank (7), which the collapse drops
    assert all(isinstance(i, int) and 0 <= i < 7 for i in ids)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_device_cuda_without_a_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda would train on it")
    write_config(corpus, tmp_path / "exp", tmp_path / "c.yaml")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_train.main([str(tmp_path / "c.yaml")])


@pytest.mark.parametrize("flag,error,match", [
    pytest.param(["--model-parallel", "2"], SystemExit,
                 "--model-parallel 2 needs --distributed.*torch.distributed.run", id="flag0"),
    pytest.param(["--pipeline", "2"], SystemExit,
                 "--pipeline 2 needs --distributed.*torch.distributed.run", id="flag1"),
    pytest.param(["--distributed"], RuntimeError,
                 "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT not set", id="flag2"),
])
def test_unported_flags_exit_naming_the_roadmap(corpus, tmp_path, monkeypatch, flag, error,
                                                 match):
    """--pipeline and --model-parallel without --distributed exit naming
    torchrun (a rank is a card); --distributed,
    which trains, raises naming torchrun's missing variables when run
    without torchrun (as jax.distributed.initialize() raises without a
    coordinator)."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    write_config(corpus, tmp_path / "exp", tmp_path / "c.yaml")
    with pytest.raises(error, match=match):
        port_train.main([str(tmp_path / "c.yaml"), "--device", "cpu", *flag])


def test_a_nonfinite_step_is_skipped_and_logged(corpus, tmp_path, monkeypatch):
    """The first update's gradients are made nan: the optimizer rejects it
    on the device, the step's log line counts it, and the package's
    optimizer count stays one behind the solver's step."""
    from openasr_torch import solvers

    mix = solvers.CTCCESolver.mix_losses
    calls = []

    def poisoned(self, losses):
        calls.append(1)
        return mix(self, losses) * (float("nan") if len(calls) == 1 else 1.0)

    monkeypatch.setattr(solvers.CTCCESolver, "mix_losses", poisoned)
    exp = tmp_path / "exp"
    write_config(corpus, exp, tmp_path / "nan.yaml", num_epoch=1)
    port_train.main([str(tmp_path / "nan.yaml"), "--device", "cpu"])
    train_rows = [r for r in read_metrics(exp) if r["phase"] == "train"]
    assert [r.get("nonfinite_skips", 0) for r in train_rows] == [1] * len(train_rows)
    state = load_package(str(exp / "last.pkg"))
    assert state["optim_state"]["notfinite"] == 1
    assert state["optim_state"]["count"] == state["solver_state"]["step"] - 1 >= 1
