"""HiFi-GAN V1's training step at its published widths on the card: two
steps of ``train.hifigan_task.train_step`` on the published batch (16
segments of 8,192 samples) against the benchmark's plain reference
(``benchmark/reference/hifigan.py``) from the same weights and ``u``, held
to the cell's own limits (``benchmark/traffic/train-hifigan.json``), and
the step's peak device memory (about 8 GB, a tenth of the card)."""

import os

import pytest
import torch

from benchmark import core
from benchmark.compare import train_hifigan as CMP
from benchmark.drivers import train_hifigan as DRV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    """The card (outside ``fp32_precision``: the step sets it itself, and the
    reference sets TF32 off through the legacy flags)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run python3 -m pytest tests_card -m card on the card")
    return "cuda"


@pytest.mark.card
def test_published_width_steps_match_the_reference(cuda):
    from tacotronv2_wavernn_chinese_tpu_torch.data.native_loader import NativeSegmentLoader
    from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_task as task

    conf = core.load_json(os.path.join(ROOT, "benchmark", "configs", "hifigan-v1.json"))
    traffic = core.load_traffic("train-hifigan")
    cfg, sections = DRV.port_config(conf), DRV.sections(conf, None)
    seed = 2**32 + 77
    loader = NativeSegmentLoader(DRV.corpus(traffic, seed), 8192, 16, seed=seed)
    try:
        batches = [task.batch_to_device(loader.next_batch(), cuda)["audio"] for _ in range(2)]
    finally:
        loader.close()
    params, sn = DRV.weights(cfg, seed, cuda)
    p0, sn0 = DRV.TC.clone(params), DRV.TC.clone(sn)
    state = task.from_params(params, sn)
    torch.cuda.reset_peak_memory_stats()
    prog = {"loss_d": [], "loss_g": [], "params": []}
    for i, b in enumerate(batches):
        state, m = task.train_step(state, {"audio": b}, cfg, steps_per_epoch=16)
        prog["loss_d"].append(m["loss_disc"])
        prog["loss_g"].append(m["loss_gen"])
        prog["params"].append(DRV.TC.clone({"gen": state.gen.params, **state.disc.params}))
        if i == 0:
            prog["mu1_g"] = DRV.TC.clone(state.gen.opt_state["mu"])
            prog["mu1_d"] = DRV.TC.clone(state.disc.opt_state["mu"])
    prog["sn"] = state.sn
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory over two steps: {peak} B ({torch.cuda.get_device_name(0)})")
    assert 1e9 < peak < 16e9
    state = None
    vals = CMP.readings(sections, p0, sn0, batches, cuda, prog)
    checks = CMP.judge(traffic["check"]["limits"], vals)
    assert all(c["ok"] for c in checks.values()), checks
