"""The port's solver: preemption, the profiler window, TensorBoard, and the
stock optimizers through the train CLI, on the CPU.

egs/aishell1/configs/conv-ctc-transformer-test.yaml on the
tools/gen_mini_corpus.py corpus (16 utterances, 4 steps an epoch):

- SIGTERM to a train subprocess stops it at the next batch; `last.pkg`
  holds the last complete epoch and the steps taken since; resumed with
  `--continue-training`, the run ends at the uninterrupted run's epoch,
  with its step count plus the steps of the interrupted part-epoch;
- `training.profile` writes a Chrome trace of its window, also when the
  window outlasts the epoch;
- `training.tensorboard` without a usable `torch.utils.tensorboard`
  warns as the JAX solver does and trains on;
- `optimtype: sgd` and `fused_adam: false` train and resume, and the
  ignored `adam_nu_dtype` is warned about.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import yaml

from openasr_torch.bin import gen_mini_corpus
from openasr_torch.bin import train as port_train
from openasr_torch.utils.checkpoint import load_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-test.yaml")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
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
    return str(path)


def read_metrics(exp_dir):
    path = os.path.join(exp_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def test_sigterm_checkpoints_and_resume_restarts_the_epoch(corpus, tmp_path):
    epochs = 12
    whole = write_config(corpus, tmp_path / "exp_whole", tmp_path / "whole.yaml",
                         num_epoch=epochs)
    port_train.main([whole, "--device", "cpu"])
    rows = read_metrics(tmp_path / "exp_whole")
    per_epoch = [r for r in rows if r["phase"] == "epoch"][0]["step"]
    total = rows[-1]["step"]
    assert total == epochs * per_epoch

    exp = tmp_path / "exp"
    cfg = write_config(corpus, exp, tmp_path / "cut.yaml", num_epoch=epochs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "openasr_torch.bin.train", cfg,
                             "--device", "cpu"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not any(r["phase"] == "train" and r["step"] >= 2 for r in read_metrics(exp)):
            assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "preemption: saved last.pkg" in out
    saved = load_package(str(exp / "last.pkg"))["solver_state"]
    done = saved["epoch"]  # complete epochs
    assert done < epochs
    part = saved["step"] - done * per_epoch  # steps of the interrupted epoch
    assert 0 <= part < per_epoch + 1
    before = len(read_metrics(exp))

    port_train.main([cfg, "--continue-training", "--device", "cpu"])
    resumed = read_metrics(exp)[before:]
    first = [r for r in resumed if r["phase"] == "train"][0]
    assert first["epoch"] == done + 1 and first["batch"] == 1
    assert first["step"] == saved["step"] + 1
    assert resumed[-1]["phase"] == "epoch" and resumed[-1]["epoch"] == epochs
    assert resumed[-1]["step"] == total + part
    final = load_package(str(exp / "last.pkg"))
    assert final["solver_state"]["epoch"] == epochs
    assert final["optim_state"]["count"] == total + part


@pytest.mark.parametrize("start,num,name", [(1, 2, "steps_1_3"), (3, 10, "steps_3_13")])
def test_profile_window_writes_a_chrome_trace(corpus, tmp_path, start, num, name):
    logdir = tmp_path / "prof"
    cfg = write_config(corpus, tmp_path / "exp", tmp_path / "p.yaml", num_epoch=1,
                       profile={"start_step": start, "num_steps": num,
                                "logdir": str(logdir)})
    port_train.main([cfg, "--device", "cpu"])
    with open(logdir / f"{name}.pt.trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert sorted(os.listdir(logdir)) == [f"{name}.pt.trace.json"]


def test_tensorboard_without_the_package_warns_and_trains(corpus, tmp_path, caplog,
                                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("OPENASR_TENSORBOARD", "1")
    cfg = write_config(corpus, tmp_path / "exp", tmp_path / "tb.yaml", num_epoch=1)
    caplog.set_level("WARNING")
    port_train.main([cfg, "--device", "cpu"])
    warned = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("tensorboard logging unavailable")]
    assert len(warned) == 1
    assert read_metrics(tmp_path / "exp")[-1]["phase"] == "epoch"


@pytest.mark.parametrize("training,keys", [
    ({"optimtype": "sgd"}, ["count", "last_finite", "notfinite", "notfinite_count", "trace"]),
    ({"fused_adam": False, "adam_nu_dtype": "bfloat16"},
     ["count", "last_finite", "mu", "notfinite", "notfinite_count", "nu"]),
])
def test_stock_optimizers_train_and_resume(corpus, tmp_path, caplog, training, keys):
    exp = tmp_path / "exp"
    caplog.set_level("WARNING")
    one = write_config(corpus, exp, tmp_path / "one.yaml", num_epoch=1, **training)
    port_train.main([one, "--device", "cpu"])
    pkg = load_package(str(exp / "last.pkg"))
    assert sorted(pkg["optim_state"]) == keys
    steps = pkg["solver_state"]["step"]
    assert pkg["optim_state"]["count"] == steps > 0
    two = write_config(corpus, exp, tmp_path / "two.yaml", num_epoch=2, **training)
    port_train.main([two, "--continue-training", "--device", "cpu"])
    assert load_package(str(exp / "last.pkg"))["optim_state"]["count"] == 2 * steps
    rows = read_metrics(exp)
    assert all(v == v for r in rows for k, v in r.items() if k.endswith("loss"))
    nu_warned = any("adam_nu_dtype=bfloat16 is ignored" in r.getMessage()
                    for r in caplog.records)
    assert nu_warned == ("adam_nu_dtype" in training)
