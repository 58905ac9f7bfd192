"""Manifest datasets, length-sorted and filtered.

Counterpart of `load_json_manifest`, `load_flist`, `SpeechDataset` and
`ArkDataset` in openasr_tpu/data/manifest.py, `TextLineByLineDataset`
(the LMs' text lines), and the phone->char sets: `PhoneCharDataset`,
`load_token_lines`, `TokenDataset` and `SemiPhoneCharDataset`.  Json
manifests carry
`uttid / feat / feat_length / tokens / token_length` rows (for waves,
`feat` is an audio path or scheme and `feat_length` its sample count; the
phone->char manifests `phones / phone_length` in place of the features);
a path may also be a directory of *.json files.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Tuple

logger = logging.getLogger(__name__)


def load_json_manifest(
    json_path: str,
    x: str = "feat_length",
    y: str = "token_length",
    x_range: Tuple[int, int] = (1, 9999),
    y_range: Tuple[int, int] = (1, 999),
    rate: Tuple[float, float] = (1, 99),
) -> List[dict]:
    """Load sample dicts from a json file or a directory of json files,
    filtering on input length, label length and in/out ratio (inclusive
    bounds)."""
    if os.path.isdir(json_path):
        data: List[dict] = []
        for d, dirs, files in os.walk(json_path):
            dirs.sort()  # deterministic traversal order
            for fn in sorted(files):
                if fn.endswith(".json"):
                    with open(os.path.join(d, fn)) as f:
                        data.extend(json.load(f))
    else:
        with open(json_path) as f:
            data = json.load(f)

    kept = []
    for sample in data:
        len_x = float(sample[x])
        len_y = float(sample.get(y, 1))
        if not (x_range[0] <= len_x <= x_range[1]):
            continue
        if y in sample and not (y_range[0] <= len_y <= y_range[1]):
            continue
        if y in sample and not (rate[0] <= len_x / max(len_y, 1e-9) <= rate[1]):
            continue
        kept.append(sample)
    logger.info(
        "manifest %s: kept %d/%d samples", json_path, len(kept), len(data)
    )
    return kept


def load_flist(flist_path: str, x_range=(1, 9999)) -> List[dict]:
    """`path<TAB>num_samples` lists (wave lists without labels)."""
    data = []
    with open(flist_path) as f:
        for i, line in enumerate(f):
            fields = line.strip().split()
            if len(fields) < 2:
                continue
            length = int(fields[1])
            if x_range[0] <= length <= x_range[1]:
                data.append({"uttid": str(i), "feat": fields[0], "feat_length": length})
    return data


class SpeechDataset:
    """Online (wave) dataset from .json or .flist manifests, sorted by
    feat_length, the sample count (longest first with `reverse`, as the
    dev sets are read)."""

    def __init__(
        self,
        data_file: str,
        feat_range=(1, 99999),
        label_range=(1, 100),
        rate_in_out=(4, 99999),
        reverse: bool = False,
    ):
        if data_file.endswith(".flist"):
            data = load_flist(data_file, x_range=feat_range)
        else:
            data = load_json_manifest(
                data_file, x_range=feat_range, y_range=label_range, rate=rate_in_out
            )
        self.data = sorted(data, key=lambda s: float(s["feat_length"]))
        if reverse:
            self.data.reverse()

    def __getitem__(self, index: int) -> dict:
        return self.data[index]

    def __len__(self) -> int:
        return len(self.data)


class ArkDataset(SpeechDataset):
    """Offline (precomputed Kaldi feature) dataset sorted by feat_length,
    the frame count."""

    def __init__(
        self,
        json_path: str,
        feat_range=(1, 99999),
        label_range=(1, 100),
        rate_in_out=(4, 999),
        reverse: bool = False,
    ):
        super().__init__(json_path, feat_range, label_range, rate_in_out, reverse)


class TextLineByLineDataset:
    """Plain text lines, in file order (LM training)."""

    def __init__(self, fn: str):
        with open(fn, encoding="utf-8") as f:
            self.data = f.read().strip().split("\n")

    def __getitem__(self, index: int) -> str:
        return self.data[index]

    def __len__(self) -> int:
        return len(self.data)


class PhoneCharDataset(TextLineByLineDataset):
    """phone->char pairs filtered on phone_length, token_length and their
    ratio (phones a character, `rate_in_out`), sorted by phone_length
    (longest first with `reverse`) when `sort`, the list repeated `multi`
    times."""

    def __init__(self, json_path: str, sort: bool = True, reverse: bool = False,
                 multi: int = 1, feat_range=(1, 99999), label_range=(1, 100),
                 rate_in_out=(2, 999)):
        data = load_json_manifest(json_path, x="phone_length", x_range=feat_range,
                                  y_range=label_range, rate=rate_in_out)
        if sort:
            data = sorted(data, key=lambda s: float(s["phone_length"]))
            if reverse:
                data.reverse()
        self.data = data * multi if multi > 1 else data


def load_token_lines(token_file: str) -> List[str]:
    """The tokens of `uttid tok tok ...` lines (a line without tokens is
    skipped)."""
    out = []
    with open(token_file, encoding="utf-8") as f:
        for line in f:
            fields = line.strip().split(maxsplit=1)
            if len(fields) == 2:
                out.append(fields[1])
    return out


class TokenDataset(TextLineByLineDataset):
    """Unpaired token lines (the GAN's phones or text), the list repeated
    `multi` times."""

    def __init__(self, token_path: str, multi: int = 1):
        data = load_token_lines(token_path)
        self.data = data * multi if multi > 1 else data


class SemiPhoneCharDataset(PhoneCharDataset):
    """The paired json (as PhoneCharDataset, sorted by phone_length) and
    the unpaired phone and text lines beside it."""

    def __init__(self, phone_path: str, text_path: str, json_path: str,
                 feat_range=(1, 99999), label_range=(1, 100), rate_in_out=(2, 999)):
        super().__init__(json_path, feat_range=feat_range, label_range=label_range,
                         rate_in_out=rate_in_out)
        self.phone_data = load_token_lines(phone_path)
        self.text_data = load_token_lines(text_path)

    def sizes(self) -> dict:
        return {"paired": len(self.data), "phone": len(self.phone_data),
                "text": len(self.text_data)}
