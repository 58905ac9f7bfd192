"""The port's training ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both.  Tolerances:
CTC and CE sums 1e-5 relative and their logit gradients 1e-5 absolute
(f32, different reduction orders); the optimizer 1e-6 relative on
parameters and moments (the same elementwise f32 formula, the bf16 first
moment rounded the same way); schedules 1e-6 relative (float32 in both,
torch here, XLA there); SpecAugment's masked regions exactly and its
fill values (means) to 1e-6; the sampler, config parsing and the
checkpoint helpers exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openasr_tpu.config import parse_range as jax_parse_range
from openasr_tpu.config import validate_config as jax_validate_config
from openasr_tpu.data.sampler import FrameBasedSampler as JaxSampler
from openasr_tpu.ops import schedules as jax_schedules
from openasr_tpu.ops.ctc import cal_ctc_loss as jax_ctc
from openasr_tpu.ops.fused_adam import fused_clip_adam
from openasr_tpu.ops.losses import cal_ce_loss as jax_ce
from openasr_tpu.ops.specaug import SpecAugConfig as JaxSpecAugConfig
from openasr_tpu.ops.specaug import spec_aug as jax_spec_aug
from openasr_tpu.utils import checkpoint as jax_ckpt
from openasr_torch.config import parse_range, validate_config
from openasr_torch.data.sampler import FrameBasedSampler
from openasr_torch.ops import schedules
from openasr_torch.ops.fused_adam import FusedClipAdam
from openasr_torch.ops.losses import cal_ce_loss, cal_ctc_loss
from openasr_torch.ops.specaug import SpecAugConfig, spec_aug
from openasr_torch.utils import checkpoint

LOSS_RTOL = 1e-5
LOGIT_GRAD_TOL = 1e-5
ADAM_RTOL = 1e-6


def _ctc_inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, t, v, u = 4, 16, 7, 5
    logits = (2 * rng.randn(b, t, v)).astype(np.float32)
    # row 2: no target; row 3: 3 frames cannot align 5 labels (inf -> 0)
    logit_lengths = np.array([16, 11, 9, 3], np.int32)
    target_lengths = np.array([5, 3, 0, 5], np.int32)
    targets = rng.randint(0, v - 1, size=(b, u)).astype(np.int32)
    return logits, logit_lengths, targets, target_lengths


def test_ctc_matches_jax_and_f_ctc_loss():
    """Sum and logit gradients against the JAX package's CTC; the feasible,
    non-empty rows also against F.ctc_loss itself."""
    logits, llen, tgt, tlen = _ctc_inputs()
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x: jax_ctc(x, llen, tgt, tlen)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss_t = cal_ctc_loss(x, torch.from_numpy(llen), torch.from_numpy(tgt),
                          torch.from_numpy(tlen))
    loss_t.backward()
    loss_t = loss_t.detach()
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert np.abs(x.grad.numpy() - np.asarray(grad_j)).max() <= LOGIT_GRAD_TOL
    direct = F.ctc_loss(
        F.log_softmax(torch.from_numpy(logits[:2]), -1).transpose(0, 1),
        torch.from_numpy(tgt[:2]).long(), torch.from_numpy(llen[:2]).long(),
        torch.from_numpy(tlen[:2]).long(), blank=6, reduction="sum")
    assert abs(float(direct) - float(loss_t)) <= LOSS_RTOL * float(direct)


@pytest.mark.parametrize("label_smooth", [0.0, 0.1])
def test_ce_matches_jax(label_smooth):
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(3, 6, 11)).astype(np.float32)
    labels = rng.randint(0, 11, size=(3, 6)).astype(np.int32)
    paddings = np.zeros((3, 6), np.float32)
    paddings[1, 4:] = 1.0
    paddings[2, 2:] = 1.0
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jax_ce(x, labels, paddings, label_smooth))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss_t = cal_ce_loss(x, torch.from_numpy(labels), torch.from_numpy(paddings),
                         label_smooth)
    loss_t.backward()
    loss_t = loss_t.detach()
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert np.abs(x.grad.numpy() - np.asarray(grad_j)).max() <= LOGIT_GRAD_TOL


def test_fused_adam_matches_jax():
    """Six steps with a bf16 first moment, clipping at norm 1 (triggered
    by the large steps), two non-finite steps that both reject, and a lr that
    depends on the count."""
    import optax

    rng = np.random.RandomState(2)
    shapes = {"w": (5, 3), "b": (3,), "g": (4,)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    # None: a step with a nan gradient, first at count 0 (zero bias corrections)
    scales = [None, 0.01, 10.0, 0.5, None, 3.0]
    grads = []
    for s in scales:
        g = {n: (rng.randn(*shape) * (s or 1.0)).astype(np.float32)
             for n, shape in shapes.items()}
        if s is None:
            g["b"][1] = np.nan
        grads.append(g)

    def lr_jax(count):
        return 1e-2 / jnp.sqrt(count.astype(jnp.float32) + 1.0)

    tx = fused_clip_adam(lr_jax, max_norm=1.0, mu_dtype=jnp.bfloat16,
                         skip_nonfinite=True)
    p_j = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(p_j)

    named = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in params.items()}
    opt = FusedClipAdam(named, lambda c: 1e-2 / torch.sqrt(c.float() + 1.0),
                        max_norm=1.0, mu_dtype=torch.bfloat16, skip_nonfinite=True)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update({n: jnp.asarray(v) for n, v in g.items()}, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        skips = int(opt.notfinite)
        opt.step([torch.from_numpy(g[n]) for n in opt.names])
        rejected = not all(np.isfinite(v).all() for v in g.values())
        assert int(opt.notfinite) == skips + rejected
        for i, n in enumerate(opt.names):
            want = np.asarray(p_j[n])
            assert np.abs(named[n].detach().numpy() - want).max() <= ADAM_RTOL * np.abs(want).max()
            assert opt.mu[i].dtype == torch.bfloat16
            assert np.array_equal(opt.mu[i].float().numpy(),
                                  np.asarray(state.mu[n]).astype(np.float32))
            nu_j = np.asarray(state.nu[n])
            assert np.abs(opt.nu[i].numpy() - nu_j).max() <= ADAM_RTOL * np.abs(nu_j).max()
    assert int(opt.count) == int(state.count) == 4
    assert int(opt.notfinite) == int(state.notfinite) == 2


def test_fused_adam_state_round_trip():
    named = {"w": torch.nn.Parameter(torch.ones(3, 2))}
    opt = FusedClipAdam(named, lambda c: 0.1)
    opt.step([torch.full((3, 2), 0.5)])
    state = opt.state_dict()
    other = FusedClipAdam({"w": torch.nn.Parameter(torch.ones(3, 2))}, lambda c: 0.1)
    other.load_state_dict(state)
    assert int(other.count) == 1 and torch.equal(other.mu[0], opt.mu[0])
    assert torch.equal(other.nu[0], opt.nu[0])
    with pytest.raises(ValueError, match="does not match"):
        FusedClipAdam({"v": torch.nn.Parameter(torch.ones(1))}, lambda c: 0.1) \
            .load_state_dict(state)


@pytest.mark.parametrize("cfg", [
    {"type": "linear", "x0": 10, "y0": 1.0, "x1": 50, "y1": 0.1},
    {"type": "warmup_linear", "warmup_step": 8, "x0": 12, "y0": 1.0, "x1": 40, "y1": 0.2},
    {"type": "warmup_transformer", "warmup_step": 20, "d_model": 512},
])
def test_schedules_match_jax(cfg):
    mine, theirs = schedules.get_schedule(cfg), jax_schedules.get_schedule(cfg)
    for step in range(0, 80):
        want = float(theirs(step))
        assert abs(mine(step) - want) <= 1e-6 * max(abs(want), 1e-30), step


def test_bob_schedule_matches_jax_with_pack_restore():
    cfg = {"type": "bob", "decay_coef": 0.5, "tolerate": 0.01}
    mine, theirs = schedules.get_schedule(cfg), jax_schedules.get_schedule(cfg)
    for loss in (10.0, 9.0, 8.99, 8.5, 8.49):
        mine.update(loss)
        theirs.update(loss)
        assert mine(0) == float(theirs(0))
    restored = schedules.get_schedule(cfg)
    restored.restore_state(mine.pack_state())
    assert restored.pack_state() == mine.pack_state() == theirs.pack_state()


def test_spec_aug_matches_jax_on_the_same_draws():
    """The JAX package draws its uniforms from a key; the port takes the
    same numbers as `u_freq` / `u_time` and must mask identically.  Widths
    larger than the bins and than a short utterance exercise the wrap of a
    negative frequency start and the empty time mask."""
    rng = np.random.RandomState(3)
    feats = rng.randn(3, 30, 10).astype(np.float32)
    lens = np.array([30, 22, 4], np.int32)
    for i, n in enumerate(lens):
        feats[i, n:] = 0.0
    cfg = dict(freq_mask_num=2, freq_mask_width=14, time_mask_num=2, time_mask_width=9)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(lambda k, x, n: jax_spec_aug(k, x, n, JaxSpecAugConfig(**cfg)))(
        key, jnp.asarray(feats), jnp.asarray(lens)))
    k_f, k_t = jax.random.split(key)
    u_f = np.array(jax.random.uniform(k_f, (2, 2, 3)))
    u_t = np.array(jax.random.uniform(k_t, (2, 2, 3)))
    got = spec_aug(torch.from_numpy(feats), torch.from_numpy(lens), SpecAugConfig(**cfg),
                   u_freq=torch.from_numpy(u_f), u_time=torch.from_numpy(u_t))
    got = got.numpy()
    assert np.array_equal(got != feats, want != feats)   # the same regions
    assert np.abs(got - want).max() <= 1e-6
    assert not np.array_equal(want, feats)


def test_sampler_batches_and_order_match_jax():
    rng = np.random.RandomState(4)
    data = [{"feat_length": int(n)} for n in np.sort(rng.randint(50, 400, size=41))]
    mine = FrameBasedSampler(data, 700, 1, shuffle=True, seed=0)
    theirs = JaxSampler(data, 700, 1, shuffle=True, seed=0)
    assert mine.batches == theirs.batches and len(mine) == len(theirs)
    for _ in range(3):  # three epochs of one seeded stream
        assert list(mine) == list(theirs)
    assert list(FrameBasedSampler(data, 700)) == list(JaxSampler(data, 700))


@pytest.mark.parametrize("value", [None, "1,1200", [3, 60], (0, 5)])
def test_parse_range_matches_jax(value):
    assert parse_range(value) == jax_parse_range(value)


def test_validate_config_matches_jax():
    cfg = {
        "data": {"trainset": "t.json", "devset": "d.json", "vocab_path": "v",
                 "feat_rnage": "1,2"},
        "model": {"type": "conv-ctc", "signal": {"feature_type": "offline"}},
        "training": {"exp_dir": "e", "num_epoch": 1, "init_lr": 1.0,
                     "optimtype": "adam", "lr_scheduler": {"type": "bob"},
                     "batch_frame": 10},
    }
    assert validate_config(cfg) == jax_validate_config(cfg)
    assert "data.feat_rnage" in validate_config(cfg)
    for required in (("training.lr_scheduler.type",), ("training.batch_frames",)):
        try:
            jax_validate_config(cfg, required)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            validate_config(cfg, required)
        else:
            with pytest.raises(ValueError) as got:
                validate_config(cfg, required)
            assert str(got.value) == want


def _write_epochs(exp_dir, save, n=4):
    for ep in range(1, n + 1):
        comp = {"encoder": {"w": np.full((2, 2), float(ep), np.float32),
                            "step": np.int32(ep)}}
        save({"model": {"model_type": "conv-ctc", "components": comp},
              "solver_state": {"epoch": ep}}, str(exp_dir / f"ep-{ep:04d}.pkg"))
    save({"model": {}}, str(exp_dir / "last.pkg"))


def test_checkpoint_helpers_match_jax(tmp_path):
    """epoch_checkpoints, cleanup_ckpt and average_packages on packages the
    JAX package wrote, against its own helpers on a copy."""
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    for d in (mine, theirs):
        d.mkdir()
        _write_epochs(d, jax_ckpt.save_package)
    assert [p.split("/")[-1] for p in checkpoint.epoch_checkpoints(str(mine))] == \
        [p.split("/")[-1] for p in jax_ckpt.epoch_checkpoints(str(theirs))]
    paths = checkpoint.epoch_checkpoints(str(mine))[-3:]
    avg = checkpoint.average_packages(paths)
    want = jax_ckpt.average_packages(jax_ckpt.epoch_checkpoints(str(theirs))[-3:])
    w_mine = avg["model"]["components"]["encoder"]["w"]
    w_jax = np.asarray(want["model"]["components"]["encoder"]["w"])
    assert w_mine.dtype == np.float32 and np.array_equal(w_mine, w_jax)
    assert avg["model"]["components"]["encoder"]["step"] == \
        want["model"]["components"]["encoder"]["step"]
    checkpoint.cleanup_ckpt(str(mine), 2)
    jax_ckpt.cleanup_ckpt(str(theirs), 2)
    assert sorted(p.name for p in mine.iterdir()) == sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in mine.iterdir()) == ["ep-0003.pkg", "ep-0004.pkg", "last.pkg"]
