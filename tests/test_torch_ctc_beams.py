"""The device CTC prefix beam against the native host beam, on the CPU and
on a CUDA card.

The device beam (`ops/ctc_beam_device.py`) runs wherever its log-probs
lie; the native decoder (`ops/prefix_beam.py`) on the host.  On seeded
peaky log-probs both must give the same n-best lists, scores within 1e-4
(f32 sums in the same order).  On the card the device beam must also give
what it gives on the CPU, with hotword biasing and on tied frames (the
stable sorts keep JAX's lowest-index order there too).  No JAX here, so the
card cases run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ctc_beams.py
"""

import numpy as np
import pytest
import torch

from openasr_torch.ops.ctc_beam_device import ctc_prefix_beam_device
from openasr_torch.ops.prefix_beam import make_decoder

TOL = 1e-4
BEAM = 10
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


def peaky_log_probs(b, t, v, seed):
    """Each frame 8 nats up on blank (60%) or a random symbol."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, v).astype(np.float32)
    target = np.where(rng.rand(b, t) < 0.6, v - 1, rng.randint(0, v - 1, size=(b, t)))
    x[np.arange(b)[:, None], np.arange(t)[None, :], target] += 8.0
    return torch.log_softmax(torch.from_numpy(x), dim=-1)


def nbest(toks, lens, scores):
    toks, lens, scores = toks.cpu().numpy(), lens.cpu().numpy(), scores.cpu().numpy()
    return [[(tuple(toks[i, n, : lens[i, n]].tolist()), float(scores[i, n]))
             for n in range(toks.shape[1]) if scores[i, n] > -1e29]
            for i in range(len(toks))]


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_device_beam_matches_native_host_beam(device):
    lp = peaky_log_probs(4, 120, 500, seed=7)
    lengths = torch.tensor([120, 97, 64, 1], dtype=torch.int32)
    got = nbest(*ctc_prefix_beam_device(lp.to(device), lengths.to(device), blank=499,
                                        beam=BEAM))
    want = make_decoder(beam_width=BEAM, blank_id=499).decode_batch(lp.numpy(),
                                                                    lengths.numpy())
    for g, w in zip(got, want):
        assert [tok for tok, _ in g] == [tuple(int(c) for c in h.tokens) for h in w]
        assert max(abs(sc - h.score) for (_, sc), h in zip(g, w)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hotwords", "ties"])
def test_device_beam_on_the_card_matches_the_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if case == "hotwords":
        lp = peaky_log_probs(3, 60, 40, seed=3)
        lengths = torch.tensor([60, 45, 30])
        kw = {"context_phrases": np.array([[5, 6, 5, 6], [7, 7, -1, -1], [9, 1, 2, -1]],
                                          np.int32),
              "context_weight": 1.5}
    else:
        lp = torch.full((2, 3, 10), float(np.log(0.1)))
        lengths = torch.tensor([3, 1])
        kw = {"cutoff_top_n": 3, "cutoff_logp": -50.0}
    v = lp.shape[-1]
    on_cpu = ctc_prefix_beam_device(lp, lengths, blank=v - 1, beam=4, **kw)
    on_card = ctc_prefix_beam_device(lp.cuda(), lengths.cuda(), blank=v - 1, beam=4, **kw)
    assert torch.equal(on_card[0].cpu(), on_cpu[0])
    assert torch.equal(on_card[1].cpu(), on_cpu[1])
    assert (on_card[2].cpu() - on_cpu[2]).abs().max() <= TOL
