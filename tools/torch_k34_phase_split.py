"""Where a step of the PyTorch port's cluster-grid kernels goes, by phase, on
one CUDA card: the trainer kernels K3 (csrc/tacotron_train_fwd.cu) and K4
(csrc/tacotron_train_bwd.cu), or the decode kernel K2
(csrc/tacotron_decode.cu).

    python3 tools/torch_k34_phase_split.py [--kernel k34|k2] [--tree DIR] [--shape ...] [--tacotron k=v,...]

Builds a clock64()-stamped copy of each kernel into build/k34_phase_split/
with nvcc and runs it through the package's own wrappers on random
full-width weights (default config): ``train_fwd`` and ``train_bwd`` at
B=32, T_in=160, T=608 (the train path's first batch), zoneout masks on
(``--shape B,T_in,T``); or, with ``--kernel k2``,
``decode_autoregressive_kernel`` at B=4, T_in=32 for 150 steps (the
branch of ``--tacotron``, e.g. ``anti_repeat=True``) with the
stop bias at -30 (the serve phase's shape; ``--shape B,T_in,steps``).
``--tree`` takes the package and its ``csrc/`` from another checkout (an
unpacked older commit), so two versions of the kernels can be split by the
same script on the same card.

A phase is a comment at the step loop's body indentation, or one level
deeper (4 or 6 spaces, ``// text``), in the kernel: a stamp goes before the
first line of each, and thread 0 of every block adds the SM cycles since
the previous stamp to the running phase's sum (in shared memory; each stamp
stores the sum to global memory, no read back).  So the time of a grid
barrier falls into the phase that holds it, unless a comment of its own
marks it.  Cycles become microseconds by each
block's total cycles over the kernel time by CUDA events.  Prints, for each
kernel, the kernel time, and us per step of each phase (mean over blocks
and the largest block's) over one timed launch; the stamps add a few
instructions and one global store per phase.  The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "build", "k34_phase_split")
MAX_BLOCKS, SLOTS = 256, 64

STAMP = f"""
__device__ long long k34_prof[{MAX_BLOCKS} * {SLOTS}];
__shared__ long long k34_sum[{SLOTS}];
__shared__ long long k34_last;
__shared__ int k34_cur;
__device__ __forceinline__ void k34_stamp(int slot) {{
  if (threadIdx.x == 0) {{
    const long long n = clock64();
    const long long t = k34_sum[k34_cur] + (n - k34_last);
    k34_sum[k34_cur] = t;
    k34_prof[blockIdx.x * {SLOTS} + k34_cur] = t;
    k34_last = n;
    k34_cur = slot;
  }}
}}
"""

HOST = f"""
extern "C" int k34_prof_get(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, k34_prof, sizeof(long long) * {MAX_BLOCKS} * {SLOTS});
}}
extern "C" int k34_prof_zero() {{
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, k34_prof);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(long long) * {MAX_BLOCKS} * {SLOTS});
}}
"""


def stamped(src: str) -> tuple[str, list[str]]:
    """The source with a stamp before every phase comment of the step loop,
    and the phases' labels (the last slot is the prologue)."""
    lines = src.split("\n")
    start = next(i for i, l in enumerate(lines) if re.match(r"^  for \(int s = ", l))
    end = next(i for i in range(start + 1, len(lines)) if lines[i] == "  }")
    labels, out = [], []
    for i, line in enumerate(lines):
        m = re.match(r"^    (?:  )?// (\S.*)$", line)
        follows = lines[i - 1].lstrip().startswith("//")  # a comment's second line starts no phase
        if start < i < end and m and not follows:
            out.append(f"    k34_stamp({len(labels)});")
            labels.append(m.group(1)[:70])
        out.append(line)
        if "extern __shared__ float4 smem4[];" in line:
            out.append(f"  if (threadIdx.x == 0) {{ for (int i = 0; i < {SLOTS}; ++i) k34_sum[i] = 0; "
                       f"k34_last = clock64(); k34_cur = {SLOTS - 1}; }}")
    if not labels or len(labels) >= SLOTS - 1:
        raise RuntimeError(f"found {len(labels)} phase comments in the step loop")
    text = "\n".join(out)
    text = text.replace("namespace {", STAMP + "\nnamespace {", 1) + HOST
    return text, labels


def build(ops, source: str):
    with open(os.path.join(ops.CSRC_DIR, source)) as f:
        src, labels = stamped(f.read())
    d = os.path.join(OUT_DIR, source.replace(".cu", ""))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(ops.CSRC_DIR):
        if f.endswith(".cuh"):
            with open(os.path.join(ops.CSRC_DIR, f)) as fi, open(os.path.join(d, f), "w") as fo:
                fo.write(fi.read())
    with open(os.path.join(d, "k.cu"), "w") as f:
        f.write(src)
    so = os.path.join(d, "k.so")
    out = subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", so, os.path.join(d, "k.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the stamped {source}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in ops._ARGTYPES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.k34_prof_get.argtypes = [ctypes.c_void_p]
    lib.k34_prof_get.restype = ctypes.c_int
    lib.k34_prof_zero.restype = ctypes.c_int
    ops._libs[source] = lib  # the wrappers' load() now returns the stamped build
    return lib, labels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k34", "k2"), default="k34")
    ap.add_argument("--tree", default=HERE, help="checkout whose package and csrc/ are split")
    ap.add_argument("--shape", default=None, help="B,T_in,T (k34: default 32,160,608; k2: steps, 4,32,150)")
    ap.add_argument("--tacotron", default="", help="k2: tacotron config fields of the branch to split, "
                    "e.g. anti_repeat=True,outputs_per_step=2 (default: the default config)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as CS  # noqa: E402  (the repo's own: inputs, bounds, timing)

    sys.path.insert(0, os.path.abspath(args.tree))
    for k in [k for k in sys.modules if k.startswith("tacotronv2_wavernn_chinese_tpu_torch")]:
        del sys.modules[k]
    import numpy as np
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    if not torch.cuda.is_available():
        print("torch_k34_phase_split: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = CS.smi_line()
    print(smi, flush=True)
    print(f"package from {os.path.dirname(ops.CSRC_DIR)}", flush=True)
    ops.build_all()
    shape = args.shape or ("4,32,150" if args.kernel == "k2" else "32,160,608")
    B, T_in, T = (int(v) for v in shape.split(","))
    tcfg = default_config().tacotron
    if args.tacotron:
        import ast
        import dataclasses

        fields = dict(kv.split("=", 1) for kv in args.tacotron.split(","))
        lit = lambda v: ast.literal_eval(v) if v not in ("forward", "lsa", "gmm", "graves") else v
        tcfg = dataclasses.replace(tcfg, **{k: lit(v) for k, v in fields.items()})
    dev = torch.device("cuda")
    params = init_tacotron(4, tcfg, device=dev)
    if args.kernel == "k2":
        from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

        libs = {"decode": build(ops, "tacotron_decode.cu")}
        params["stop_projection"] = dict(params["stop_projection"],
                                         b=torch.full_like(params["stop_projection"]["b"], -30.0))
        rng = np.random.default_rng(33)
        V = 2 * tcfg.encoder_lstm_units
        memory = torch.as_tensor(rng.uniform(-1, 1, (B, T_in, V)), dtype=torch.float32, device=dev)
        mask = torch.ones(B, T_in, device=dev)
        runs = {"decode": lambda: DK.decode_autoregressive_kernel(params, tcfg, memory, mask, list(range(B)), T)}
        names = {"decode": "K2 decode"}
    else:
        from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

        libs = {name: build(ops, f"tacotron_train_{name}.cu") for name in ("fwd", "bwd")}
        x = CS.core_inputs(params, tcfg, B, T, T_in, dev, 33)
        w = TK.pack_core_weights(params, tcfg)
        call = (w, x["pre"], x["masks"], x["keys"], x["values"], x["mask"], float(tcfg.zoneout_rate))
        box = {"fwd": TK.train_fwd(*call)}
        runs = {"fwd": lambda: TK.train_fwd(*call),
                "bwd": lambda: TK.train_bwd(*call, box["fwd"], list(x["cots"]))}
        names = {"fwd": "K3 fwd", "bwd": "K4 bwd"}
    record = {"device": smi, "tree": os.path.abspath(args.tree), "kernel": args.kernel, "B": B, "T_in": T_in,
              "T": T, "tacotron": args.tacotron, "kernels": []}
    for name, (lib, labels) in libs.items():
        runs[name]()  # warm
        ops.check_launch(lib.k34_prof_zero(), "k34_prof_zero")
        ms = CS.cuda_ms(runs[name])
        prof = np.zeros(MAX_BLOCKS * SLOTS, np.int64)
        ops.check_launch(lib.k34_prof_get(prof.ctypes.data), "k34_prof_get")
        prof = prof.reshape(MAX_BLOCKS, SLOTS).astype(np.float64)
        used = prof.sum(1) > 0
        blocks = prof[used]
        clock = blocks.sum(1) / (ms * 1e-3)  # cycles per second of each block
        per = blocks / clock[:, None] / T * 1e6  # us per step
        print(f"{names[name]}: {ms:.2f} ms, {ms / T * 1e3:.2f} us/step, "
              f"{int(used.sum())} blocks, SM clock {clock.mean() / 1e9:.3f} GHz", flush=True)
        phases = []
        for i, lab in enumerate(labels + ["prologue"]):
            col = per[:, i if i < len(labels) else SLOTS - 1]
            if lab == "prologue":
                col = col * T  # once per launch: us
            phases.append({"phase": lab, "us_per_step": float(col.mean()), "max": float(col.max())})
            unit = "us" if lab == "prologue" else "us/step"
            print(f"   {i:2d} {lab[:60]:60s} {col.mean():8.2f} (max {col.max():8.2f}) {unit}", flush=True)
        record["kernels"].append({"name": name, "ms": ms, "us_per_step": ms / T * 1e3,
                                  "blocks": int(used.sum()), "phases": phases})
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
