"""``calibrate.py`` for the HiFi-GAN training cell, whose driver
``calibrate.py`` does not know by name: the same readings, with ``--fault``
planted in the HiFi-GAN training step the cell drives (a step that returns
its state's params unchanged, or that steps on the first half of its
batch).

    python3 benchmark/calibrate_hifigan.py --workload hifigan-v1.train-gan --seeds 1,2,3 --seconds 4 \
        [--fault unchanged|half_batch] [--out file.json]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(fault: str) -> None:
    from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_task as task

    orig = task.train_step

    def broken(state, batch, *args, **kw):
        if fault == "unchanged":
            new, metrics = orig(state, batch, *args, **kw)
            keep = lambda old, ts: task.TrainState(ts.step, old.params, ts.opt_state)
            return task.HiFiGANState(new.step, keep(state.gen, new.gen), keep(state.disc, new.disc), new.sn), metrics
        return orig(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, *args, **kw)

    task.train_step = broken


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--fault", default=None, choices=("unchanged", "half_batch"))
    args, rest = ap.parse_known_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import calibrate as C

    if args.fault:
        plant(args.fault)
    print(f"fault planted in the HiFi-GAN training step: {args.fault or 'none'}", flush=True)
    return C.main(rest)


if __name__ == "__main__":
    sys.exit(main())
