"""``calibrate.py`` for the location-sensitive Tacotron-2 training cell,
whose driver ``calibrate.py`` does not know by name: the same readings,
with ``--fault`` planted in the Tacotron training step the cell drives.

    python3 benchmark/calibrate_lsa.py --workload shen-lsa.train-tacotron --seeds 1,2,3 --seconds 8 \
        [--fault unchanged|half_batch] [--out file.json]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--fault", default=None, choices=("unchanged", "half_batch"))
    args, rest = ap.parse_known_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import calibrate as C

    if args.fault:
        C.plant(args.fault, "train_tacotron")
    print(f"fault planted in the Tacotron training step: {args.fault or 'none'}", flush=True)
    return C.main(rest)


if __name__ == "__main__":
    sys.exit(main())
