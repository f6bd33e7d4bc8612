"""Time the eager route's teacher-forced decode on the card: the eager loop
over ``decoder_step`` against its CUDA graphs (``models.decoder_graph``),
forward and backward, at the published Tacotron 2's widths (LSA, a 2 x
1,024 decoder, batch 64, train mode with zoneout).

    python3 tools/torch_decoder_graph_split.py [--T_in 160] [--steps 224,928] [--repeats 3]

For each decoder length, each way: the forward's and the backward's
device time (CUDA events around work that ends in a synchronise; the
backward is autograd from a weighted sum of the outputs), the host time
of each, the peak device memory over a forward and backward, and, from
one profiled forward and backward, the host's kernel and graph launches
and the device operations they ran.  The graphs' first decode at a key
(warm-up, capture and replays) is timed apart, with the memory the key
keeps afterwards.  One JSON line to standard output.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SHEN = dict(embedding_dim=512, enc_conv_channels=512, encoder_lstm_units=256, attention_mode="lsa",
            attention_dim=128, attention_filters=32, attention_kernel=31, prenet_layers=(256, 256),
            decoder_lstm_units=1024, postnet_channels=512)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def decode_fn(graphed: bool):
    """(params, memory, pre_all, masks) -> (out2, ctx, aligns) through
    the graphs or the eager loop."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.models import attention as ATT
    from tacotronv2_wavernn_chinese_tpu_torch.models import decoder_graph as DG
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    def run(params, tc, memory, mem_mask, pre_all, zone):
        keys = ATT.precompute_keys(params["attention"], tc, memory)
        w_comb, b_comb = ATT.combined_location_weights(params["attention"])
        if graphed:
            return DG.decode(params, tc, True, pre_all, zone, None, keys, memory, mem_mask, w_comb, b_comb)
        carry = T.init_decoder_carry(tc, memory.shape[0], memory.shape[1], memory.shape[2], memory.device)
        outs = []
        for t in range(pre_all.shape[0]):
            z = ((zone[0][t], zone[1][t]), (zone[2][t], zone[3][t]))
            out2, ctx, align, carry = T.decoder_step(params, tc, None, carry, keys, memory, mem_mask, None,
                                                     w_comb, b_comb, train=True, zoneout_masks=z,
                                                     pre=pre_all[t], project=False)
            outs.append((out2, ctx, align))
        return tuple(torch.stack(v) for v in zip(*outs))

    return run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T_in", type=int, default=160)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", default="224,928")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
    from tacotronv2_wavernn_chinese_tpu_torch.models import decoder_graph as DG
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron
    from tacotronv2_wavernn_chinese_tpu_torch.utils.precision import fp32_precision

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    tc = dataclasses.replace(default_config().tacotron, **SHEN)
    B, T_in = args.batch, args.T_in
    params = tree_map(lambda p: p.requires_grad_(True), init_tacotron(0, tc, device=dev))
    g = torch.Generator(device=dev).manual_seed(1)
    lens = torch.linspace(T_in, T_in // 3, B, device=dev).long()
    memory = (torch.randn(B, T_in, 2 * tc.encoder_lstm_units, generator=g, device=dev)
              * T.input_mask(lens, T_in)[..., None]).requires_grad_(True)
    mem_mask = T.input_mask(lens, T_in)
    out = {"device": torch.cuda.get_device_name(0), "B": B, "T_in": T_in, "rows": []}

    def timed(fn):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.monotonic()
        e0.record()
        r = fn()
        e1.record()
        h1 = time.monotonic()
        torch.cuda.synchronize()
        return r, e0.elapsed_time(e1), 1e3 * (h1 - h0)

    with fp32_precision():
        for steps in [int(s) for s in args.steps.split(",")]:
            pre_all = torch.rand(steps, B, 256, generator=g, device=dev).requires_grad_(True)
            zone = tuple(torch.rand(steps, B, tc.decoder_lstm_units, generator=g, device=dev) < 0.9
                         for _ in range(4))
            cot = [torch.randn(steps, B, n, generator=g, device=dev) for n in (1024, 512, T_in)]
            leaves = [memory, pre_all] + tree_leaves(params)
            for graphed in (False, True):
                run = decode_fn(graphed)

                def fwd():
                    return run(params, tc, memory, mem_mask, pre_all, zone)

                def bwd(outs):
                    return torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)), leaves,
                                               allow_unused=True)

                row = {"steps": steps, "way": "graphs" if graphed else "eager"}
                if graphed:
                    DG._GRAPHS.clear()
                    DG._ARENAS.clear()
                    torch.cuda.synchronize()
                    a0 = torch.cuda.memory_allocated()
                    c0 = DG.DECODER_GRAPHS["captures"]
                    h0 = time.monotonic()
                    outs = fwd()
                    torch.cuda.synchronize()
                    h1 = time.monotonic()
                    bwd(outs)
                    torch.cuda.synchronize()
                    row.update(first_forward_ms=1e3 * (h1 - h0), first_backward_ms=1e3 * (time.monotonic() - h1),
                               captures=DG.DECODER_GRAPHS["captures"] - c0)
                    del outs
                    # what one key keeps allocated between decodes: the arena at T_cap = steps, the
                    # static inputs and weights and their accumulators (a capture empties the
                    # allocator's cache, so the graphs' pools cannot be read from the reserved bytes)
                    row.update(kept_allocated_bytes=torch.cuda.memory_allocated() - a0)
                f_dev, f_host, b_dev, b_host = [], [], [], []
                for _ in range(args.repeats):
                    outs, d, h = timed(fwd)
                    f_dev.append(d)
                    f_host.append(h)
                    _, d, h = timed(lambda: bwd(outs))
                    b_dev.append(d)
                    b_host.append(h)
                    del outs
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                bwd(fwd())
                torch.cuda.synchronize()
                row.update(forward_ms=statistics.median(f_dev), forward_host_ms=statistics.median(f_host),
                           backward_ms=statistics.median(b_dev), backward_host_ms=statistics.median(b_host),
                           peak_bytes=torch.cuda.max_memory_allocated() - base)
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    bwd(fwd())
                    torch.cuda.synchronize()
                ev = prof.events()
                row["kernel_launches"] = sum(1 for e in ev if e.name in LAUNCHES)
                row["graph_launches"] = sum(1 for e in ev if e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch")))
                row["device_ops"] = sum(1 for e in ev if e.device_type == torch.autograd.DeviceType.CUDA)
                print(json.dumps(row), file=sys.stderr, flush=True)
                out["rows"].append(row)
            del pre_all, zone, cot
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
