"""The port stands alone: importing it pulls in neither JAX nor openasr_tpu."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "openasr_torch")
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|openasr_tpu)\b", re.M)


def _port_modules():
    mods = []
    for d, _, files in os.walk(PORT):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, fn), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    for name in ("bin.infer", "bin.train", "kernels.flash_attention", "kernels.layer_norm",
                 "solvers", "ops.fused_adam", "ops.losses", "ops.schedules", "ops.specaug",
                 "utils.checkpoint", "config", "data.sampler", "data.audio", "ops.fbank",
                 "kernels.fbank", "ops.ctc_decode", "ops.prefix_beam", "ops.ctc_beam_device",
                 "utils.metrics", "bin.wer", "ops.cif", "models.assigner", "models.cif",
                 "solvers.cif", "models.lm", "bin.train_lm", "data.manifest",
                 "data.collate", "streaming", "bin.stream_infer", "kernels.ops", "quant",
                 "serving", "bin.export_decode", "models.frontend", "models.encoder",
                 "models.speech", "models.cpc", "models.wav2vec", "solvers.cpc",
                 "bin.train_cpc", "data.tokenizer", "parallel.pipeline",
                 "bin.stack_encoder_pkg", "bin.avg_last_ckpts", "utils.timer", "utils.trace",
                 "bin.profile_step", "bin.bench_flash", "bin.plot_attention",
                 "bin.convert_reference_pkg", "bin.gen_wav_flist", "bin.gen_libri_json"):
        assert f"openasr_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'openasr_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_source_imports_jax_or_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    offenders = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            src = f.read()
        offenders += [f"{os.path.relpath(p, ROOT)}: {m.group(0).strip()}"
                      for m in FORBIDDEN.finditer(src)]
    assert offenders == []
