"""Where a step of the PyTorch port's WaveRNN sample-loop kernel (K1) goes,
by phase, on one CUDA card.

    python3 tools/torch_k1_phase_split.py

Builds two variants of tacotronv2_wavernn_chinese_tpu_torch/csrc/wavernn_sample.cu
into build/k1_phase_split/ with nvcc:

  stamped        the kernel as it is, plus clock64() stamps read by thread 0
                 of every block: "stage" runs from the end of the previous
                 grid barrier to the start of the phase's products (the
                 staging copies, and in phase 1 the argmax merge), "work"
                 from there to the barrier (products, epilogue), "barrier"
                 the grid barrier itself.  With several fold tiles, "stage"
                 also holds the earlier tiles' work.
  barriers_only  the same loop with every phase's fold-tile loop skipped:
                 five grid barriers per step and nothing else.

and runs both on random full-width weights (default config) at 3, 16 and 256
folds, greedy.  Prints, per fold count and variant, the kernel time by CUDA
events, the labels' agreement with the plain version (stamped, up to 16
folds), and us per step of each phase's stage / work / barrier (the mean over
blocks, and the largest block's).  The stamps add a few instructions per
phase; the kernel line of chip_smoke.py times the kernel without them.
The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

OUT_DIR = os.path.join(HERE, "build", "k1_phase_split")
SLOTS = ("stage", "work", "barrier")

STAMP = """
__shared__ long long s_prof[18];
__shared__ long long s_last;
__shared__ int s_ph;
__device__ __forceinline__ void stamp(int slot) {
  if (threadIdx.x == 0) { long long n = clock64(); s_prof[s_ph * 3 + slot] += n - s_last; s_last = n; }
}
"""

# (anchor in the source, text that replaces it); each anchor must occur once
PATCHES = (
    ('#include "rng.cuh"\n', '#include "rng.cuh"\n' + STAMP),
    ("""__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();""", """__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  stamp(1);
  __syncthreads();"""),
    ("""    } while (v < target);
  }
  __syncthreads();
}""", """    } while (v < target);
  }
  __syncthreads();
  stamp(2);
  if (threadIdx.x == 0) s_ph = s_ph == 5 ? 1 : s_ph + 1;
  __syncthreads();
}"""),
    ("""  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int fg = nf4 >> 2;""", """  stamp(0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int fg = nf4 >> 2;"""),
    ("""  extern __shared__ float4 smem4[];""", """  extern __shared__ float4 smem4[];
  if (threadIdx.x == 0) { for (int i = 0; i < 18; ++i) s_prof[i] = 0; s_ph = 0; s_last = clock64(); }
  __syncthreads();"""),
    ("""  // labels of the last step, each fold by the block that owns it""", """  if (threadIdx.x == 0) {
    long long* prof = reinterpret_cast<long long*>(p.counter + 64) + blockIdx.x * 32;
    for (int i = 0; i < 18; ++i) prof[i] = s_prof[i];
  }
  // labels of the last step, each fold by the block that owns it"""),
)


def variants(src: str) -> dict:
    for anchor, _ in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"wavernn_sample.cu changed: the stamp anchor {anchor[:60]!r} is gone")
    for anchor, text in PATCHES:
        src = src.replace(anchor, text)
    loop = "for (int f0 = 0; f0 < B; f0 += FT)"
    return {"stamped": src, "barriers_only": src.replace(loop, "for (int f0 = 0; f0 < 0; f0 += FT)")}


def build(ops, name: str, src: str):
    """nvcc one variant beside copies of the kernel's headers -> ctypes."""
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(ops.CSRC_DIR):
        if f.endswith(".cuh"):
            with open(os.path.join(ops.CSRC_DIR, f)) as fi, open(os.path.join(d, f), "w") as fo:
                fo.write(fi.read())
    with open(os.path.join(d, "k.cu"), "w") as f:
        f.write(src)
    out = subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(os.path.join(d, "k.so"))
    lib.wavernn_sample_launch.argtypes = ops._ARGTYPES["wavernn_sample_launch"]
    lib.wavernn_sample_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as CS
    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W
    from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn

    if not torch.cuda.is_available():
        print("torch_k1_phase_split: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = CS.smi_line()
    print(smi, flush=True)
    with open(os.path.join(ops.CSRC_DIR, "wavernn_sample.cu")) as f:
        libs = {name: build(ops, name, src) for name, src in variants(f.read()).items()}
    wcfg = default_config().wavernn
    params = init_wavernn(1, wcfg, device="cuda")
    w = WK.pack_weights(params, wcfg)
    H, FC, NC = wcfg.rnn_dims, wcfg.fc_dims, w["wfc3"].shape[0]
    plan = WK.choose_k1_plan(H, FC, NC, torch.cuda.get_device_properties(0).multi_processor_count)
    G = plan.blocks
    rng = np.random.default_rng(3)
    record = {"device": smi, "blocks": G, "fold_tile": plan.fold_tile, "runs": []}

    def launch(lib, cond):
        T, B, _ = cond.shape
        labels = torch.empty((T, B), dtype=torch.int32, device="cuda")
        scratch = torch.zeros(plan.scratch_floats(B), dtype=torch.float32, device="cuda")
        counter = torch.zeros(64 + 64 * G, dtype=torch.int32, device="cuda")  # counter, then stamps
        err = lib.wavernn_sample_launch(
            ops.ptr(cond), *[ops.ptr(w[k]) for k in WK.WEIGHT_ORDER], ops.ptr(labels), ops.ptr(scratch),
            ops.ptr(counter), T, B, H, FC, NC, G, plan.fold_tile, 1, 0, ops.stream_ptr(torch.device("cuda")))
        ops.check_launch(err, "stamped wavernn_sample")
        return labels, counter

    for B, frames in ((3, 4), (16, 4), (256, 1)):
        mels = torch.as_tensor(rng.uniform(0.0, 1.0, (B, frames + 2 * wcfg.pad, 80)), dtype=torch.float32,
                               device="cuda")
        cond = W.precompute_conditioning(params, wcfg, mels)
        T = cond.shape[0]
        plain = WK.sample_labels_plain(cond, w, 0, greedy=True) if B <= 16 else None
        for name, lib in libs.items():
            box = {}
            ms = CS.cuda_ms(lambda: box.__setitem__("r", launch(lib, cond)), warmup=True)
            labels, counter = box["r"]
            stamps = counter[64:].view(torch.int64).view(G, 32)[:, :18].double().cpu().numpy()
            clock = stamps.sum(1).mean() / (ms * 1e-3)  # SM cycles per second over the launch
            mean = stamps.mean(0) / clock / T * 1e6
            top = stamps.max(0) / clock / T * 1e6
            agree = None if plain is None or name != "stamped" else bool(torch.equal(labels, plain))
            print(f"B={B} T={T} {name}: {ms:.2f} ms, {ms / T * 1e3:.2f} us/step, labels == plain: {agree}, "
                  f"SM clock {clock / 1e9:.3f} GHz", flush=True)
            run = {"folds": B, "T": T, "variant": name, "ms": ms, "us_per_step": ms / T * 1e3,
                   "labels_equal_plain": agree, "phases": []}
            for ph in range(1, 6):
                print(f"   phase {ph}: " + ", ".join(
                    f"{s} {mean[ph * 3 + i]:.2f} (max {top[ph * 3 + i]:.2f})" for i, s in enumerate(SLOTS)), flush=True)
                run["phases"].append({s: float(mean[ph * 3 + i]) for i, s in enumerate(SLOTS)})
            record["runs"].append(run)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
