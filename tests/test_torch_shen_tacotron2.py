"""Tacotron 2 as published (Shen et al. 2018; ``benchmark/configs/
tacotron2-shen-lsa.json``): location-sensitive attention trained through
the port's ``train_step`` on the CPU, held to the benchmark's plain LSA
reference (``benchmark/reference/tacotron_lsa.py``) at small widths, with
the same weights, batch and masks; the configuration file through
``benchmark.portcfg``; and the LSA decoder's work count by hand."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import core, portcfg  # noqa: E402
from benchmark.compare import train_tacotron as CMP  # noqa: E402
from benchmark.compare import train_tacotron_lsa as CMP_LSA  # noqa: E402
from benchmark.weights import make_params  # noqa: E402
from benchmark.work import lsa as WL  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron  # noqa: E402

CONF = core.load_json(os.path.join(ROOT, "benchmark", "configs", "tacotron2-shen-lsa.json"))
# the benchmark tests' TINY widths (benchmark/tests/conftest.py), the attention LSA as configured
TINY = {"tacotron": {"embedding_dim": 16, "enc_conv_channels": 32, "encoder_lstm_units": 16, "attention_dim": 16,
                     "attention_filters": 4, "prenet_layers": [16, 16], "decoder_lstm_units": 16,
                     "postnet_channels": 16},
        "tacotron_train": {"batch_size": 3}}
SEED = 2**33 + 17
STEP_SEED = 2**35 + 5


def _batch(B=3, T_in=14, T_out=24):
    rng = np.random.default_rng(7)
    in_lens = np.asarray([T_in, 11, 6], np.int32)[:B]
    lens = np.asarray([T_out, 19, 12], np.int32)[:B]
    inputs = rng.integers(1, 190, (B, T_in)).astype(np.int32) * (np.arange(T_in)[None] < in_lens[:, None])
    mels = np.full((B, T_out, 80), -4.0, np.float32)
    for b, n in enumerate(lens):
        mels[b, :n] = rng.uniform(-4, 4, (n, 80))
    b = {"inputs": inputs.astype(np.int32), "input_lengths": in_lens, "mel_targets": mels,
         "stop_targets": (np.arange(T_out)[None] >= lens[:, None] - 1).astype(np.float32),
         "target_lengths": lens, "loss_frames": np.full((B,), T_out, np.int32)}
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def stepped():
    """The port's first step and the reference's on the same weights, batch
    and masks."""
    cfg = portcfg.build(CONF, TINY)
    sections = {s: portcfg.section(CONF, s, TINY) for s in portcfg.SECTIONS}
    params = make_params(init_tacotron(0, cfg.tacotron, device="meta"), SEED, "cpu")
    batch = _batch()
    state = task.TrainState(0, params, task.adam_init(params))
    gen = torch.Generator().manual_seed(STEP_SEED)
    new, metrics = task.train_step(state, batch, gen, cfg)
    return cfg, sections, params, batch, new, metrics


def _reference(sections, params, batch, cumulative=True):
    conf = dict(sections, tacotron=dict(sections["tacotron"], cumulative_weights=cumulative))
    return CMP_LSA.reference_steps(conf, params, [batch], [STEP_SEED], "cpu")


def _gaps(cfg, sections, params, new, metrics, ref):
    """(relative loss gap, worst leaf's gradient gap over its largest
    element or the median leaf's, whichever is larger, worst BatchNorm
    statistic's gap).  The floor: a convolution's bias right before
    BatchNorm has a true gradient of zero, so what both compute for it is
    rounding."""
    b1 = cfg.tacotron_train.adam_beta1
    got_g = {k: v / (1.0 - b1) for k, v in CMP.leaves(new.opt_state["mu"])}
    top = {k: float(g.abs().max()) for k, g in ref["g1"].items()}
    floor = float(np.median(list(top.values())))
    grad = max(float((got_g[k] - g).abs().max()) / max(top[k], floor) for k, g in ref["g1"].items())
    got_p = dict(CMP.leaves(new.params))
    bn = max(float((got_p[k] - v).abs().max()) for k, v in ref["params"].items() if k[-1] in ("mean", "var"))
    return abs(metrics["loss"] - ref["losses"][0]) / abs(ref["losses"][0]), grad, bn


def test_train_step_matches_the_lsa_reference(stepped):
    """Tolerances: the loss is a few masked means over B x T x 80 terms,
    summed in another order (1e-5 relative is 100 x f32's rounding of such
    sums); a gradient flows back through 24 recurrent steps whose products
    the port and the reference order differently (the energies' v as a sum
    against a product, the encoder LSTM's plain K5/K6 against a loop), so
    each leaf is held to 1e-4 of its largest element (``_gaps``); the BatchNorm
    statistics are one reduction over every position (1e-5)."""
    cfg, sections, params, batch, new, metrics = stepped
    assert T.core_route(cfg.tacotron, True, 1.0) == "eager"
    loss_gap, grad_gap, bn_gap = _gaps(cfg, sections, params, new, metrics, _reference(sections, params, batch))
    assert loss_gap < 1e-5 and grad_gap < 1e-4 and bn_gap < 1e-5, (loss_gap, grad_gap, bn_gap)


def test_a_reference_without_cumulated_weights_is_told_apart(stepped):
    """The control: the reference's location features from the last
    alignment alone fails the same tolerances."""
    cfg, sections, params, batch, new, metrics = stepped
    loss_gap, grad_gap, _ = _gaps(cfg, sections, params, new, metrics,
                                  _reference(sections, params, batch, cumulative=False))
    assert loss_gap >= 1e-5 or grad_gap >= 1e-4, (loss_gap, grad_gap)


def test_the_configuration_builds_at_its_published_widths():
    cfg = portcfg.build(CONF)  # raises on a key the port's config lacks
    t = cfg.tacotron
    assert (t.attention_mode, t.embedding_dim, t.enc_conv_channels, t.decoder_lstm_units, t.postnet_channels,
            cfg.tacotron_train.batch_size) == ("lsa", 512, 512, 1024, 512, 64)
    assert CONF["reduced"] == [] and T.core_route(t, True, cfg.tacotron_train.teacher_forcing_ratio) == "eager"
    assert sum(x.numel() for x in tree_leaves(init_tacotron(0, t, device="meta"))) == 27_263_905


def test_unknown_keys_are_refused():
    with pytest.raises(KeyError):
        portcfg.build(dict(CONF, tacotron=dict(CONF["tacotron"], attention_width=7)))


@pytest.mark.parametrize("frames, symbols", [(24, 7), (900, 149)])
def test_lsa_work_by_hand(frames, symbols):
    t = CONF["tacotron"]
    # prenet 80x256 + 256x256; LSTM1 (256 + 512 + 1024) x 4096; LSTM2 2048 x 4096; query 1024 x 128;
    # per symbol: location filter 31 x 128, v 128, context 512; projections 1536 x 81
    step = 80 * 256 + 256 * 256 + 1792 * 4096 + 2048 * 4096 + 1024 * 128 + symbols * (31 * 128 + 128 + 512) \
        + 1536 * 81
    assert WL.step_macs(t, symbols) == step
    flops, nbytes = WL.row_work(t, frames, symbols)
    assert flops == 2.0 * (symbols * 512 * 128 + frames * step)
    assert nbytes == 4.0 * (symbols * 513 + frames * 80 + frames * (81 + symbols))
    weights = (80 * 256 + 256 + 256 * 256 + 256 + 1792 * 4096 + 2048 * 4096 + 8 * 1024 + 1024 * 128 + 512 * 128
               + 31 * 128 + 3 * 128 + 1537 * 81)
    assert WL.decode_work(t, [(frames, symbols)] * 2) == (2 * flops, 2 * nbytes + 4.0 * weights)


def test_the_decoder_tree_has_no_forward_attention_leaves():
    cfg = portcfg.build(CONF, TINY)
    att = init_tacotron(0, cfg.tacotron, device="meta")["attention"]
    assert "mu_layer" not in att and {"location_conv", "location_layer", "query_layer", "memory_layer"} <= set(att)
    assert dataclasses.asdict(cfg.tacotron)["cumulative_weights"] is True
