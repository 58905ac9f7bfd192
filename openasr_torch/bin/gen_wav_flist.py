"""Walk a directory and write a `path<TAB>num_samples` flist (CPC data
prep).

Counterpart of tools/gen_wav_flist.py, with the same arguments and
output, importing nothing of the JAX package (the port's
`data/audio.py:load_wave` has the same WAV and FLAC decoders):

  python -m openasr_torch.bin.gen_wav_flist --wav-dir <dir> --ext .flac \
      --output train.flist
"""

from __future__ import annotations

import argparse
import os

from openasr_torch.data.audio import load_wave


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav-dir", dest="wav_dir", required=True)
    parser.add_argument("--ext", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    num = 0
    with open(args.output, "w") as fw:
        for root, _, files in os.walk(args.wav_dir):
            for fn in sorted(files):
                if fn.endswith(args.ext):
                    path = os.path.abspath(os.path.join(root, fn))
                    _, sig = load_wave(path)
                    fw.write(f"{path}\t{len(sig)}\n")
                    num += 1
    print(f"saved {num} samples")


if __name__ == "__main__":
    main()
