"""The port's random draws, checked by their distribution on the CPU.

The WaveRNN sampler (``ops.wavernn_kernel.sample_labels_plain``: bits from
``hash_bits``, Gumbel noise from ``gumbel_from_bits``, argmax) against the
softmax of known logits, by a chi-square test as
tests/test_sampling_distribution.py does for the JAX scan path: every
weight zero, the fc3 bias set to the logits, so every sample is an iid
draw from softmax(bias).  On the card the sample-loop kernel draws the same
bits, and chip_smoke.py holds its labels equal to the plain version's.  And
the prenet dropout's keep rate (``prenet_keep_masks``, ``keep_threshold``)
against the binomial bound."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn
from tools.check_kernel_sampling import chi_square, target_logits

BITS = 8


def _wcfg():
    cfg = default_config().wavernn
    return dataclasses.replace(cfg, upsample_factors=(2, 2, 5), rnn_dims=32, fc_dims=32, compute_dims=16,
                               res_out_dims=128, res_blocks=2)


def _zeroed_with_bias(wcfg, logits: np.ndarray):
    params = init_wavernn(0, wcfg, bits=BITS)

    def zero(tree):
        if isinstance(tree, dict):
            return {k: zero(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zero(v) for v in tree]
        return torch.zeros_like(tree)

    params = zero(params)
    params["fc3"]["b"] = torch.as_tensor(logits)
    return params


def test_sampler_matches_the_softmax():
    """8 folds x 1000 samples, 8 target classes with probabilities 1..8 / 36
    and the rest at logit -30: the chi-square statistic over the 8 classes
    and the tail stays under its critical value at alpha 1e-3."""
    wcfg = _wcfg()
    n_classes = 2 ** BITS
    lo, k = 40, 8
    logits = target_logits(n_classes, lo, k)
    params = _zeroed_with_bias(wcfg, logits)
    mels = torch.zeros(8, 50 + 2 * wcfg.pad, 80)  # 50 frames x hop 20 = 1000 samples a fold
    out = W.generate_scan(params, wcfg, mels, seed=3, bits=BITS, apply_mu_law=False)
    assert tuple(out.shape) == (8, 1000)
    labels = np.rint((out.numpy().astype(np.float64) + 1.0) * (n_classes - 1) / 2.0).astype(np.int64)
    stat, crit, df = chi_square(labels, logits, lo, k)
    assert np.isin(labels, np.arange(lo, lo + k)).mean() > 0.999
    assert stat < crit, (stat, crit, df)
    # the folds draw different streams: no two folds agree on every sample
    assert len({tuple(r) for r in labels.tolist()}) == 8


def test_greedy_sampler_is_the_argmax():
    wcfg = _wcfg()
    logits = target_logits(2 ** BITS, 40, 8)
    params = _zeroed_with_bias(wcfg, logits)
    mels = torch.zeros(2, 4 + 2 * wcfg.pad, 80)
    out = W.generate_scan(params, wcfg, mels, seed=0, bits=BITS, apply_mu_law=False, greedy=True)
    labels = np.rint((out.numpy().astype(np.float64) + 1.0) * (2 ** BITS - 1) / 2.0).astype(np.int64)
    assert np.all(labels == int(np.argmax(logits)))


@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_prenet_keep_rate(rate):
    """200 seeds x 10 steps x (256 + 256) lanes = 1,024,000 draws per rate:
    the kept share of each layer within 5 binomial standard deviations of
    1 - rate, and the two layers' masks differ."""
    seeds = DK.row_seeds(list(range(200)), 200, "cpu")
    k1, k2 = [], []
    for step in range(10):
        a, b = DK.prenet_keep_masks(seeds, step, 256, 256, rate)
        k1.append(a)
        k2.append(b)
    k1, k2 = torch.stack(k1), torch.stack(k2)
    keep = 1.0 - rate
    for m in (k1, k2):
        n = m.numel()
        sigma = (keep * (1.0 - keep) / n) ** 0.5
        assert abs(float(m.double().mean()) - keep) < 5 * sigma, (float(m.double().mean()), keep, sigma)
    assert not torch.equal(k1, k2)
