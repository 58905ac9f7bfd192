"""The port's Kaldi matrix reader against the JAX package's on `cmd |`
pipe inputs, as Kaldi recipes write them into scp files."""

import io
import shlex

import numpy as np
import pytest

from openasr_tpu.data import kaldi_io as jax_kaldi_io
from openasr_torch.data import kaldi_io


@pytest.fixture
def written(tmp_path):
    """A matrix written by the port's writer: an ark (key, then the
    matrix at `offset`) and a file holding the matrix alone."""
    mat = np.random.RandomState(0).randn(7, 5).astype(np.float32)
    kaldi_io.write_ark_scp(str(tmp_path / "feats"), [("utt1", mat)])
    buf = io.BytesIO()
    offset = kaldi_io.write_mat(buf, mat, "utt1")
    alone = tmp_path / "m:1.mat"  # a ':' inside the command is no offset
    alone.write_bytes(buf.getvalue()[offset:])
    return mat, tmp_path / "feats.ark", offset, alone


@pytest.mark.parametrize("how", ["cat file", "tail of the ark", "colon in the command"])
def test_pipe_reads_match_jax(written, tmp_path, how):
    mat, ark, offset, alone = written
    cmd = {
        "cat file": f"cat {shlex.quote(str(alone))} |",
        "tail of the ark": f"tail -c +{offset + 1} {shlex.quote(str(ark))} |",
        "colon in the command": f"cat {shlex.quote(str(alone))}|",
    }[how]
    scp = tmp_path / "pipes.scp"
    scp.write_text(f"utt1 {cmd}\n")
    got = kaldi_io.read_mat(cmd)
    want = jax_kaldi_io.read_mat(cmd)
    [(key, want_scp)] = list(jax_kaldi_io.read_mat_scp(str(scp)))
    # the port reads an scp line's path the way its manifests hand it over
    utt, path = scp.read_text().strip().split(" ", 1)
    assert (utt, key) == ("utt1", "utt1")
    got_scp = kaldi_io.read_mat(path, writable=False)
    assert np.array_equal(got, want) and np.array_equal(got, mat)
    assert np.array_equal(got_scp, want_scp) and np.array_equal(got_scp, mat)
