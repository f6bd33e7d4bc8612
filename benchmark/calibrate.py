"""The readings that a cell's limits are set from: for each seed, one run
of the cell (a short window at the cell's own load), the numbers compared
for the program's outputs and, in the same process, for the control (the
reference computed with TF32 in the program's place).  Each number's
largest and smallest reading over the seeds is printed: the largest of a
sound program sets a limit's lower reading, the smallest of a planted
fault (``--fault``) or of the control its upper one.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 8 [--rate r] [--out file.json]

The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(fault: str, kind: str) -> None:
    """Break the timed path underneath a training cell: the step returns
    its state unchanged, or steps on the first half of its batch (the mean
    taken over the rest)."""
    import importlib

    task = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.train."
                                   + {"train_tacotron": "tacotron_task", "train_wavernn": "wavernn_task"}[kind])
    orig = task.train_step

    def broken(state, batch, *args, **kw):
        if fault == "unchanged":
            new, metrics = orig(state, batch, *args, **kw)
            return task.TrainState(new.step, state.params, new.opt_state), metrics
        return orig(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, *args, **kw)

    task.train_step = broken


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rate", type=float, default=None, help="arrivals a second, replacing the mix's")
    ap.add_argument("--fault", default=None, choices=("unchanged", "half_batch"),
                    help="training cells: a step that returns its state unchanged, or that leaves out half its batch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import core
    from benchmark import run as R

    R.set_environment(ROOT)
    spec = core.load_spec(ROOT)
    core.require_cards(int(core.find_cell(spec, args.workload)["chips"]))
    if args.fault:
        plant(args.fault, core.load_traffic(core.find_cell(spec, args.workload)["traffic"], ROOT)["kind"])
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0, rate=args.rate)
        ctx = R.make_context(ns, t_start=time.monotonic())
        ctx.control = True
        try:
            out = core.driver(ctx.traffic["kind"]).run(ctx)
        finally:
            shutil.rmtree(ctx.workdir, ignore_errors=True)
        row = {"seed": seed, "program": out["readings"], "control": out["control"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=1)
    keys = [k for k in rows[0]["program"] if isinstance(rows[0]["program"][k], (int, float))]
    print("fault planted: " + (args.fault or "none"))
    for k in keys:
        prog = [r["program"][k] for r in rows]
        ctrl = [r["control"][k] for r in rows if k in r["control"]]
        # with a fault planted the program's smallest reading is the upper one
        print(f"{k}: program max {max(prog)!r}, min {min(prog)!r} (of {len(prog)}), "
              f"control min {min(ctrl) if ctrl else None!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
