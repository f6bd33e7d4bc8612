"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; last comes ``checks``, each compared number beside
its limit, which standard error repeats as its last lines.  Without a CUDA
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result.  ``--rate`` replaces the traffic mix's arrival rate (the
knee sweep); the cells' runs do not use it.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def set_environment(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries that could load JAX told not to."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton_cache"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def make_context(args, root: str = ROOT, device=None, patch=None, workdir=None, t_start=None):
    """Everything a driver reads: the cell, its files, the seed and the
    window."""
    from benchmark import core, portcfg

    spec = core.load_spec(root)
    cell = core.find_cell(spec, args.workload)
    conf = core.load_config(spec, cell["config"], root)
    traffic = core.load_traffic(cell["traffic"], root)
    sections = {s: portcfg.section(conf, s, patch) for s in portcfg.SECTIONS}
    return types.SimpleNamespace(
        spec=spec, cell=cell, conf=conf, conf_sections=sections, traffic=traffic, seed=int(args.seed),
        seconds=float(args.seconds), trace=bool(int(args.trace)), rate=args.rate, device=device or "cuda",
        patch=patch, workdir=workdir or tempfile.mkdtemp(prefix="bench-"),
        t_start=T_START if t_start is None else t_start)


def run_cell(ctx) -> tuple:
    """(result line, checks text) of one run of ``ctx``'s cell."""
    from benchmark import core

    drv = core.driver(ctx.traffic["kind"])
    out = drv.run(ctx)
    wanted = core.cell_metrics(ctx.spec, ctx.cell["name"], ctx.trace)
    metrics = {}
    for m in wanted:
        if ctx.trace:
            v = core.metric_reader(m["name"])(out["record"])
        else:
            v = out["e2e"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    found = core.forbidden_modules()
    if found:
        raise core.BenchError("JAX or the JAX package was loaded: " + ", ".join(found))
    checks = out["checks"]
    correct = all(c["ok"] for c in checks.values())
    line = core.result_line(correct, out["attempted"], out["failed"], metrics, out["device"], checks,
                            out.get("breakdown") if ctx.trace else None)
    return line, core.checks_text(checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None, help="arrivals a second, replacing the mix's (sweeps only)")
    args = ap.parse_args(argv)
    set_environment(ROOT)
    sys.path.insert(0, ROOT)
    from benchmark import core

    ctx = None
    try:
        cell = core.find_cell(core.load_spec(ROOT), args.workload)
        core.require_cards(int(cell["chips"]))
        ctx = make_context(args)
        line, text = run_cell(ctx)
    except core.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    finally:
        if ctx is not None:
            shutil.rmtree(ctx.workdir, ignore_errors=True)
    print(line, flush=True)
    print(text, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
