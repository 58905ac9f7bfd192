"""Average the last N epoch checkpoints of an experiment into avgN.pkg.

Counterpart of tools/avg_last_ckpts.py, with the same arguments and
output, importing nothing of the JAX package (`egs/*/avg.sh` runs the
JAX tool; this one takes the same directory):

  python -m openasr_torch.bin.avg_last_ckpts <exp_dir> <N>

The model components of the newest N `ep-NNNN.pkg` are averaged in f64
and written back as f32 (`utils/checkpoint.py:average_last_ckpts`); the
rest of the package is the first averaged one's.
"""

from __future__ import annotations

import argparse
import os

from openasr_torch.utils.checkpoint import average_last_ckpts


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("exp_dir")
    parser.add_argument("num", type=int)
    args = parser.parse_args(argv)
    out = os.path.join(args.exp_dir, f"avg{args.num}.pkg")
    average_last_ckpts(args.exp_dir, args.num, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
