"""sclite-style trn scorer: per-utterance alignment and a system summary.

Counterpart of tools/sclite_score.py, importing nothing of the JAX
package, with the same flags and byte for byte the same report: it reads
NIST trn files ("token token ... (utt_id)" lines) or plain "utt_id
token..." files, aligns each hypothesis against its reference
(`utils.metrics.align_stats`), and writes an `-o all`-like report: each
utterance's Corr/Sub/Del/Ins counts and a system summary in percent.

  python -m openasr_torch.bin.sclite_score -r ref.trn -h2 hyp.trn --cer [--per-spk]
"""

from __future__ import annotations

import argparse
import re
import sys

from openasr_torch.bin.wer import split_chars
from openasr_torch.utils.metrics import align_stats

TRN_RE = re.compile(r"^(.*)\(([^()]+)\)\s*$")


def read_any(path: str, char_level: bool) -> dict:
    """Read trn ('tokens (uttid)') or 'uttid tokens' lines, told apart line
    by line."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = TRN_RE.match(line)
            if m:
                utt, text = m.group(2).strip(), m.group(1)
            else:
                fields = line.split(maxsplit=1)
                utt = fields[0]
                text = fields[1] if len(fields) > 1 else ""
            out[utt] = split_chars(text, char_level)
    return out


def speaker_of(utt: str) -> str:
    """The speaker sclite groups by: the id before its last '-' or '_'
    group, else the whole id."""
    for sep in ("-", "_"):
        if sep in utt:
            return utt.rsplit(sep, 1)[0]
    return utt


def main(argv=None):
    parser = argparse.ArgumentParser(description="sclite-style scoring without sctk")
    parser.add_argument("-r", "--ref", required=True)
    parser.add_argument("-h2", "--hyp", required=True)
    parser.add_argument("-o", "--out", default="-", help="report path ('-' = stdout)")
    parser.add_argument("--cer", action="store_true",
                        help="CJK-aware character-level scoring")
    parser.add_argument("--per-spk", action="store_true", help="add a per-speaker table")
    args = parser.parse_args(argv)

    refs = read_any(args.ref, args.cer)
    hyps = read_any(args.hyp, args.cer)

    lines = []
    tot = {"cor": 0, "sub": 0, "del": 0, "ins": 0, "n_ref": 0}
    spk = {}
    n_snt, n_err_snt = 0, 0
    for utt in refs:
        hyp = hyps.get(utt, [])
        st = align_stats(refs[utt], hyp)
        n_ref = len(refs[utt])
        cor = n_ref - st["sub"] - st["del"]
        n_snt += 1
        n_err_snt += int(st["sub"] + st["del"] + st["ins"] > 0)
        tot["cor"] += cor
        tot["sub"] += st["sub"]
        tot["del"] += st["del"]
        tot["ins"] += st["ins"]
        tot["n_ref"] += n_ref
        s = spk.setdefault(speaker_of(utt), {"cor": 0, "sub": 0, "del": 0, "ins": 0, "n": 0})
        s["cor"] += cor
        s["sub"] += st["sub"]
        s["del"] += st["del"]
        s["ins"] += st["ins"]
        s["n"] += n_ref
        lines.append(
            f"id: ({utt})\n"
            f"Scores: (#C #S #D #I) {cor} {st['sub']} {st['del']} {st['ins']}\n"
            f"REF:  {' '.join(refs[utt])}\n"
            f"HYP:  {' '.join(hyp)}\n"
        )

    n = max(tot["n_ref"], 1)
    err = 100.0 * (tot["sub"] + tot["del"] + tot["ins"]) / n
    summary = (
        ",-----------------------------------------------------------------.\n"
        "|                       SYSTEM SUMMARY                            |\n"
        "|-----------------------------------------------------------------|\n"
        f"| # Snt {n_snt:>6} | # Wrd {tot['n_ref']:>8} "
        f"| Snt Err {100.0 * n_err_snt / max(n_snt, 1):6.1f}%           |\n"
        f"| Corr {100.0 * tot['cor'] / n:6.1f}% | Sub {100.0 * tot['sub'] / n:6.1f}% "
        f"| Del {100.0 * tot['del'] / n:6.1f}% | Ins {100.0 * tot['ins'] / n:6.1f}% |\n"
        f"| Err  {err:6.1f}%                                                  |\n"
        "`-----------------------------------------------------------------'\n"
    )
    report = summary + "\n" + "\n".join(lines)
    if args.per_spk:
        rows = []
        for name in sorted(spk):
            s = spk[name]
            sn = max(s["n"], 1)
            rows.append(f"{name:<24} Err "
                        f"{100.0 * (s['sub'] + s['del'] + s['ins']) / sn:6.2f}% "
                        f"({s['n']} wrd)")
        report += "\nPER-SPEAKER:\n" + "\n".join(rows) + "\n"

    if args.out == "-":
        sys.stdout.write(report)
    else:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(report)
        print(f"Err {err:.2f}% -> {args.out}")
    return err


if __name__ == "__main__":
    main()
