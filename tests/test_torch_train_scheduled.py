"""Scheduled sampling (teacher-forcing ratio below 1) in the port's
Tacotron training, against the JAX package's XLA step, f32 on the CPU.

Per step and row the decoder takes the ground-truth frame where JAX's draw
``uniform(k_tf) < ratio`` says so, else the last frame it predicted at the
step before.  JAX's draws and masks are rebuilt from its key and injected
(tests/torch_train_parity.py); the tolerances are
tests/test_torch_train_model.py's (loss 2e-5 relative, gradients 5e-4 of
each leaf's max|g|, BN statistics 1e-5 relative; measured at r = 1 and 2:
loss 1.5e-7, gradients 2.1e-6 beyond a 1e-7 floor, statistics 1.2e-6)."""


import jax
import numpy as np
import pytest
import torch

import torch_train_parity as P
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron


@pytest.mark.parametrize("r", [1, 2])
def test_scheduled_step_matches_jax(r):
    """Ratio 0.5, forward attention (the eager route's scheduled loop):
    loss, every gradient and the BN statistics."""
    jcfg, tcfg = P.cfgs(tacotron={"outputs_per_step": r})
    params = P.jax_params(jcfg)
    batch = P.batch_np()
    assert TT.core_route(tcfg.tacotron, True, 0.5) == "eager"
    use_gt = P.jax_masks(params, jcfg, jax.random.PRNGKey(9), batch, True, 0.5).use_gt
    assert use_gt.shape == (P.T_OUT // r, P.B, 1) and 0 < int(use_gt.sum()) < use_gt.numel()
    P.assert_step_matches(P.run_step(jcfg, tcfg, params, batch, ratio=0.5))


def _decode(params, cfg, batch, rand, ratio):
    memory = TT.encode(params, cfg, batch["inputs"], batch["input_lengths"])
    mask = TT.input_mask(batch["input_lengths"], batch["inputs"].shape[1])
    return TT.decode_teacher_forced(params, cfg, memory, mask, batch["mel_targets"], True, rand, ratio)


@pytest.mark.parametrize("mode", ["forward", "lsa"])
def test_full_ratio_batched_route_equals_scheduled_loop(mode):
    """At ratio 1 the port takes the batched route (forward: the kernel
    route; LSA: the eager loop with the prenet and projections batched),
    where JAX's scheduled mode runs its scan with every draw true: the
    scheduled loop with ``use_gt`` all set gives the same frames, stops and
    alignments within 1e-5."""
    _, tcfg = P.cfgs(tacotron={"attention_mode": mode})
    cfg = tcfg.tacotron
    params = init_tacotron(3, cfg)
    batch = {k: torch.as_tensor(v) for k, v in P.batch_np().items()}
    gen = torch.Generator().manual_seed(1)
    rand = TT.draw_train_rand(params, cfg, P.B, P.T_IN, P.T_OUT, gen, True, 0.5)
    everyone = rand._replace(use_gt=torch.ones_like(rand.use_gt))
    batched = _decode(params, cfg, batch, rand, 1.0)
    looped = _decode(params, cfg, batch, everyone, 0.999)
    for a, b in zip(batched, looped):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_fed_back_frame_is_not_detached():
    """Gradients flow through the model's own predictions, as in the JAX
    package (no stop_gradient on the fed-back frame): with every draw
    false, the stop logits of step 1 depend on the frame projection only
    through step 0's predicted frame, and their gradient there is not 0."""
    _, tcfg = P.cfgs(dropout=0.0, zoneout=0.0)
    cfg = tcfg.tacotron
    params = init_tacotron(3, cfg)
    w = params["frame_projection"]["w"].clone().requires_grad_(True)
    params = dict(params, frame_projection=dict(params["frame_projection"], w=w))
    batch = {k: torch.as_tensor(v) for k, v in P.batch_np().items()}
    rand = TT.TrainRand(*[None] * 7, use_gt=torch.zeros(P.T_OUT, P.B, 1, dtype=torch.bool))
    _, stops, _ = _decode(params, cfg, batch, rand, 0.0)
    (g,) = torch.autograd.grad(stops[:, 1].sum(), w)
    assert float(g.abs().max()) > 1e-4


def test_draws_and_schedule():
    """``draw_train_rand`` draws ``use_gt`` only below ratio 1, at the
    ratio's rate; a scheduled run takes train steps past the point where
    the cosine decay drops below 1, with finite losses."""
    _, tcfg = P.cfgs(teacher_forcing_mode="scheduled", teacher_forcing_init_ratio=1.0,
                     teacher_forcing_final_ratio=0.3, teacher_forcing_start_decay=0,
                     teacher_forcing_decay_steps=4)
    cfg = tcfg.tacotron
    params = init_tacotron(0, cfg)
    gen = torch.Generator().manual_seed(0)
    assert TT.draw_train_rand(params, cfg, 8, 5, 400, gen, True, 1.0).use_gt is None
    use_gt = TT.draw_train_rand(params, cfg, 8, 5, 400, gen, False, 0.3).use_gt
    assert use_gt.dtype == torch.bool and abs(float(use_gt.float().mean()) - 0.3) < 0.05
    ratios = [TTask.teacher_forcing_schedule(tcfg, s) for s in range(3)]
    assert ratios[0] == 1.0 and 0.3 < ratios[2] < 1.0
    state = TTask.init_state(0, tcfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in P.batch_np().items()}
    for _ in range(3):
        state, metrics = TTask.train_step(state, batch, gen, tcfg)
        assert np.isfinite(metrics["loss"])
