"""Generate a synthetic multi-speaker corpus in the hierarchical layout with
the PyTorch port (port-side copy of ``scripts/make_synthetic_corpus.py``,
which imports the JAX package): ``data.synthetic.write_hierarchical_corpus``
writes that script's files byte for byte at the same arguments
(``out/{train,val,test}/spk<s>/utt<u>/wav``, each a joblib-format
energy-normalized utterance). It writes files only: no device is used.

Usage:
    python scripts/torch_make_synthetic_corpus.py --out /path/corpus \
        --train_speakers 40 --utts 60 --fs 8000 --seconds 4.0
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--train_speakers", type=int, default=40)
    p.add_argument("--val_speakers", type=int, default=10)
    p.add_argument("--test_speakers", type=int, default=10)
    p.add_argument("--utts", type=int, default=60)
    p.add_argument("--val_utts", type=int, default=20)
    p.add_argument("--fs", type=int, default=8000)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus

    write_hierarchical_corpus(args.out, args.train_speakers, args.val_speakers,
                              args.test_speakers, args.utts, args.val_utts, fs=args.fs,
                              seconds=args.seconds, seed=args.seed)
    print(f"corpus written to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
