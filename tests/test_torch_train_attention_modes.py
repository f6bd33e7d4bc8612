"""The port's Tacotron training in every attention configuration the JAX
package trains, and its teacher-forced eval, against the JAX package's XLA
step (``tacotron_task.loss_fn``, ``fused_core`` off on the CPU), f32.

Widths 32, B=3, T_in=16, T_out=20, dropout 0.5 and zoneout 0.1, with every
mask JAX draws (encoder, prenet, zoneout, GMM attention dropout, postnet)
rebuilt from its key and injected (tests/torch_train_parity.py).  Loss
within 2e-5 relative, every gradient leaf within 5e-4 of its max|g|, BN
statistics within 1e-5 relative: the tolerances of
tests/test_torch_train_model.py (measured: loss 4.5e-7 relative at most,
gradients 1.7e-5 of max|g| beyond a 1e-7 floor, BN statistics 1.5e-6,
alignments 1.0e-6, GMM the largest).  These configurations take the port's
eager route (``models.tacotron.core_route``), the counterpart of JAX's
scan, on every device."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_train_parity as P
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import tacotron_from_numpy

MODES = {
    "lsa_cumulative": {"attention_mode": "lsa", "cumulative_weights": True},
    "lsa_not_cumulative": {"attention_mode": "lsa", "cumulative_weights": False},
    "gmm": {"attention_mode": "gmm"},
    "graves": {"attention_mode": "graves"},
    "forward_smoothing": {"smoothing": True},
    # eval mode: the LSA synthesis window and forward anti-repeat act
    "eval_lsa_window": {"attention_mode": "lsa", "synthesis_constraint": True, "synthesis_window": 3},
    "eval_anti_repeat": {"anti_repeat": True},
}


@pytest.mark.parametrize("name", list(MODES))
def test_step_matches_jax(name):
    """Loss, every gradient and the BN statistics of one step (eval cases:
    of the eval loss) with JAX's masks injected."""
    train = not name.startswith("eval_")
    jcfg, tcfg = P.cfgs(tacotron=MODES[name])
    assert TT.core_route(tcfg.tacotron, train, 1.0) == "eager"
    params = P.jax_params(jcfg)
    res = P.run_step(jcfg, tcfg, params, P.batch_np(), train=train)
    P.assert_step_matches(res, train=train)
    np.testing.assert_allclose(res["out"].alignments.detach().numpy(), np.asarray(res["jout"].alignments),
                               rtol=0, atol=1e-5)
    if name == "gmm":  # the attention dropout acted: some masked [query, context] inputs
        assert not bool(torch.all(P.jax_masks(params, jcfg, jax.random.PRNGKey(9), P.batch_np()).att))


def test_train_mode_ignores_eval_constraints():
    """In training anti-repeat and the LSA window do not act (JAX
    ``_forward_step`` L275, ``_lsa_step`` L301): a config with them trains
    exactly as one without, and forward attention with anti-repeat keeps
    the kernel route in training."""
    cfg = P.cfgs()[1].tacotron
    assert TT.core_route(dataclasses.replace(cfg, anti_repeat=True), True, 1.0) == "kernel"
    assert TT.core_route(dataclasses.replace(cfg, anti_repeat=True), False, 1.0) == "eager"
    assert TT.core_route(cfg, False, 1.0) == "kernel"
    jcfg, _ = P.cfgs(tacotron={"attention_mode": "lsa"})
    params = tacotron_from_numpy(P.jax_params(jcfg), jcfg.tacotron)
    batch = {k: torch.as_tensor(v) for k, v in P.batch_np().items()}
    outs = []
    for extra in ({}, {"synthesis_constraint": True, "anti_repeat": True}):
        c = dataclasses.replace(jcfg.tacotron, **extra)
        out, _ = TT.forward_teacher_forced(params, c, batch["inputs"], batch["input_lengths"],
                                           batch["mel_targets"], True, generator=torch.Generator().manual_seed(3))
        outs.append(out)
    torch.testing.assert_close(outs[0].alignments, outs[1].alignments, rtol=0, atol=0)


@pytest.mark.parametrize("anti_repeat", [False, True])
def test_eval_decode_applies_anti_repeat_like_jax(anti_repeat):
    """The teacher-forced eval decode (eval_step, GTA, the eval renders)
    with ``anti_repeat``: B=2, T_in=16, T_out=40, widths 32, zoneout 0.1,
    dropout 0, the same weights.  JAX applies the constraint whenever
    ``anti_repeat and not train``; the port's kernel route had no
    anti-repeat and ignored it (on these weights alignments 0.78 apart,
    mels 0.090).  Within 1e-5 (measured: alignments 1.8e-7 without
    anti-repeat, 1.2e-7 with it; mels 2.7e-7 both)."""
    jcfg, tcfg = P.cfgs(dropout=0.0, zoneout=0.1, tacotron={"anti_repeat": anti_repeat})
    params = P.jax_params(jcfg, seed=1)
    rng = np.random.default_rng(4)
    inputs = rng.integers(1, 191, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 12], np.int32)
    mels = rng.uniform(-4, 4, (2, 40, 80)).astype(np.float32)
    jout, _ = jax.jit(JT.forward_teacher_forced, static_argnums=(1, 5))(
        params, jcfg.tacotron, inputs, lens, mels, False, jax.random.PRNGKey(0))
    tout, _ = TT.forward_teacher_forced(
        tacotron_from_numpy(params, tcfg.tacotron), tcfg.tacotron, torch.as_tensor(inputs),
        torch.as_tensor(lens), torch.as_tensor(mels), False, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tout.alignments.numpy(), np.asarray(jout.alignments), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.mel_outputs.numpy(), np.asarray(jout.mel_outputs), rtol=0, atol=1e-5)
