"""Mixed precision (bf16 weights, f32 master; ``utils/precision.py``) in
the port's Tacotron and WaveRNN training, against the JAX package's
``loss_fn`` with ``mixed_precision=True``, on the CPU.

The bf16 tolerance.  Loss and its terms within 1e-3 relative (measured:
the Tacotron loss 2.0e-5, its stop term 1.9e-4; RAW 7e-8, MOL 4.5e-6).
Every gradient leaf within 5e-2 of its max|g| of JAX's (measured 3.2e-2
with forward attention, on the kernel route, 1.7e-2 with LSA, on the eager
one; 1.5e-2 RAW, 1.4e-2 MOL).  BN statistics within 1e-2 of each
vector's max|x| (measured 3.7e-3: the batch mean of the bf16 convolution
output is itself bf16, and one rounding flip moves it a bf16 ulp).

What the gate tells apart (``python tests/test_torch_train_mixed_precision.py``
prints each reading): the port in f32 against JAX's mixed step reads 0.12
(forward) and 0.24 (LSA) on the prenet's first layer, RAW 0.17, MOL 0.25;
the first encoder convolution in f32 instead of bf16 x bf16 reads 7.2e-2
(forward).  The test holds both outside the gate, and every gradient of a
rounded leaf to a bf16 value (rounded once, after the sum over its uses).

Where the 3.2e-2 comes from.  With XLA's excess precision off
(``XLA_FLAGS=--xla_allow_excess_precision=false``) the Tacotron loss gap
falls to 1.5e-7 and the gradients to 1.4e-2 (forward) and 2.0e-2 (LSA):
by default XLA keeps f32 between the bf16 operations of the first encoder
convolution and its BatchNorm, where torch rounds each.  The rest, on the
decoder LSTMs' and the GRUs' weights and biases, is JAX's scans summing
the recurrent weights' cotangents in bf16 across the steps (the cast sits
inside the loop), where the port sums in f32 and rounds once: against
float64 on the same bf16-rounded weights the port's GRU gradient sits
2.2e-3 of max|g| away and JAX's 1.6e-2, which the WaveRNN test checks."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as P
from test_torch_port_wavernn_train import _batch as wavernn_batch
from test_torch_port_wavernn_train import _cfgs as wavernn_cfgs
from test_torch_port_wavernn_train import _init as wavernn_init
from test_torch_port_wavernn_train import _t as wavernn_t
from tacotronv2_wavernn_chinese_tpu.train import wavernn_task as JWTask
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as TWTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import precision as PR
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, wavernn_from_numpy

LOSS_RTOL, GRAD_ATOL, STAT_RTOL = 1e-3, 5e-2, 1e-2


def _f32(cfg, field: str):
    """``cfg`` with ``field``'s mixed precision off."""
    return dataclasses.replace(cfg, **{field: dataclasses.replace(getattr(cfg, field), mixed_precision=False)})


def _tacotron_runs(mode: str, variants=("mixed", "f32", "f32_first_conv")) -> dict:
    """One step of each port variant against JAX's mixed step, with JAX's
    masks injected: the port's mixed step, the port in f32, and the port
    with the first encoder convolution in f32 (every leaf rounded and
    upcast, none left bf16)."""
    jcfg, tcfg = P.cfgs(tacotron={"attention_mode": mode}, mixed_precision=True)
    params, batch = P.jax_params(jcfg), P.batch_np()
    runs = {}
    for name in variants:
        if name == "f32_first_conv":
            TTask.P = types.SimpleNamespace(cast_params=lambda t: PR.cast_params(t, low=()),
                                            merge_master=PR.merge_master, cast_to_float32=PR.cast_to_float32)
        try:
            runs[name] = P.run_step(jcfg, _f32(tcfg, "tacotron_train") if name == "f32" else tcfg, params, batch)
        finally:
            TTask.P = PR
    return runs


@pytest.mark.parametrize("mode", ["forward", "lsa"])
def test_tacotron_mixed_step_matches_jax(mode):
    """One step, forward attention on the kernel route (the trainer
    kernels' plain versions on the bf16-rounded weights) and LSA on the
    eager route; the port in f32 misses the gate, and so, with forward
    attention, does the port with the first encoder convolution in f32."""
    _, tcfg = P.cfgs(tacotron={"attention_mode": mode}, mixed_precision=True)
    assert TT.core_route(tcfg.tacotron, True, 1.0) == ("kernel" if mode == "forward" else "eager")
    runs = _tacotron_runs(mode, ("mixed", "f32", "f32_first_conv") if mode == "forward" else ("mixed", "f32"))
    P.assert_step_matches(runs["mixed"], LOSS_RTOL, GRAD_ATOL, STAT_RTOL, stat_scale=STAT_RTOL)
    assert all(t.dtype == torch.float32 for t in tree_leaves(runs["mixed"]["new"]))
    for name in runs.keys() - {"mixed"}:
        assert P.grad_error(runs[name]) > GRAD_ATOL, name


def _wavernn_grads(mode: str, mixed: bool = True):
    """JAX's mixed RAW or MOL step and the port's (mixed, or f32 with
    ``mixed=False``) -> (JAX loss, grads, new params, port loss, new
    params, grads, port params, port config, port batch)."""
    jcfg, tcfg = wavernn_cfgs(mode=mode, train=dict(batch_size=3, seq_len_hops=3, test_samples=1,
                                                     mixed_precision=True))
    jp, b = wavernn_init(jcfg), wavernn_batch(jcfg, 1)
    (jl, (jnew, _)), jg = jax.jit(jax.value_and_grad(JWTask.loss_fn, has_aux=True), static_argnums=(1, 3))(
        jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()}, True)
    tp = wavernn_from_numpy(jp, tcfg.wavernn)
    tl, tnew, tg = TWTask.compute_grads(tp, tcfg if mixed else _f32(tcfg, "wavernn_train"), wavernn_t(b))
    return jl, jg, jnew, tl, tnew, tg, tp, tcfg, b


def _wavernn_grad_error(jg, tg) -> float:
    """``torch_train_parity.grad_error`` for a WaveRNN step."""
    return P.grad_error({"jgrads": jg, "grads": {jax.tree_util.keystr(p): P._at(tg, p).numpy()
                                                 for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]}})


def test_wavernn_mixed_step_matches_jax():
    """RAW and MOL: loss, every gradient and the BN statistics against
    JAX's ``loss_fn`` (the port in f32 misses the gradient gate); the
    GRU's recurrent-weight gradient nearer float64 (the same bf16-rounded
    weights) than JAX's."""
    for mode in ("RAW", "MOL"):
        jl, jg, jnew, tl, tnew, tg, tp, tcfg, b = _wavernn_grads(mode)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        for p, a in jax.tree_util.tree_flatten_with_path(jg)[0]:
            a = np.asarray(a)
            np.testing.assert_allclose(P._at(tg, p).numpy(), a, rtol=0,
                                       atol=GRAD_ATOL * max(float(np.abs(a).max()), 1e-6) + 1e-7,
                                       err_msg=f"{mode} gradient {jax.tree_util.keystr(p)}")
        for p, a in jax.tree_util.tree_flatten_with_path(jnew)[0]:
            a = np.asarray(a)
            np.testing.assert_allclose(P._at(tnew, p).detach().numpy(), a, rtol=STAT_RTOL,
                                       atol=1e-6 + STAT_RTOL * float(np.abs(a).max()))
        assert all(t.dtype == torch.float32 for t in tree_leaves(tnew))
        assert _wavernn_grad_error(jg, _wavernn_grads(mode, mixed=False)[5]) > GRAD_ATOL, mode
    # the RAW step in float64 on the bf16-rounded weights (BN statistics f32)
    p64 = tree_map(lambda t: t.double(), PR.cast_params(tp))
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in wavernn_t(b).items()}
    _, _, g64 = TWTask.compute_grads(p64, _f32(tcfg, "wavernn_train"), b64)
    for gru in ("gru1", "gru2"):
        ref = g64[gru]["wh"].numpy()
        port = np.abs(tg[gru]["wh"].numpy() - ref).max()
        assert port < np.abs(np.asarray(jg[gru]["wh"]) - ref).max(), gru
        assert port < 5e-3 * np.abs(ref).max(), gru


def test_policy_and_master():
    """``cast_params`` keeps BN and attention f32 and the embedding and the
    first encoder convolution bf16, and rounds every other weight to bf16
    in f32; ``merge_master`` takes the BN statistics from the forward and
    the weights from the master, bit for bit; without the L2 term (taken
    on the f32 master) a mixed step's gradients are bf16 values for every
    rounded leaf (an f32 step's are not); its new params stay f32."""
    jcfg, tcfg = P.cfgs(dropout=0.0, zoneout=0.0, mixed_precision=True, reg_weight=0.0)
    params = init_tacotron(0, tcfg.tacotron)
    cast = PR.cast_params(params)
    assert cast["attention"] is params["attention"]
    assert cast["embedding"].dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in cast["enc_convs"]["layers"][0]["conv"].values())
    w, w0 = cast["dec_lstm1"]["w"], params["dec_lstm1"]["w"]
    assert w.dtype == torch.float32 and torch.equal(w, w0.bfloat16().float()) and not torch.equal(w, w0)
    assert cast["enc_convs"]["layers"][1]["conv"]["w"].dtype == torch.float32
    for lp in cast["enc_convs"]["layers"]:
        assert all(t.dtype == torch.float32 for t in tree_leaves(lp["bn"]))
    bn = cast["postnet"]["layers"][0]["bn"]
    computed = dict(cast, postnet={"layers": [dict(cast["postnet"]["layers"][0], bn=dict(bn, mean=bn["mean"] + 1.0)),
                                              *cast["postnet"]["layers"][1:]]})
    merged = PR.merge_master(params, computed)
    assert merged["dec_lstm1"]["w"] is params["dec_lstm1"]["w"] and merged["embedding"] is params["embedding"]
    torch.testing.assert_close(merged["postnet"]["layers"][0]["bn"]["mean"], bn["mean"] + 1.0)
    out = PR.cast_to_float32(TT.TacotronOutput(*(torch.ones(2, dtype=torch.bfloat16),) * 4))
    assert all(t.dtype == torch.float32 for t in out[:4]) and out.stop_lengths is None

    batch = {k: torch.as_tensor(v) for k, v in P.batch_np().items()}
    grads = [TTask.compute_grads(params, c, batch, torch.Generator().manual_seed(0), 0)[3]
             for c in (tcfg, _f32(tcfg, "tacotron_train"))]
    w16, w32 = grads[0]["dec_lstm1"]["w"], grads[1]["dec_lstm1"]["w"]
    assert w16.dtype == torch.float32 and float((w16 - w32).abs().max()) > 1e-4 * float(w32.abs().max())
    bf16_values = lambda g: [torch.equal(r.float(), t) for t, r in zip(tree_leaves(g), tree_leaves(PR.cast_params(g)))]
    assert all(bf16_values(grads[0])) and not all(bf16_values(grads[1]))
    state = TTask.init_state(0, tcfg, "cpu")
    state, metrics = TTask.train_step(state, batch, torch.Generator().manual_seed(0), tcfg)
    assert np.isfinite(metrics["loss"]) and all(t.dtype == torch.float32 for t in tree_leaves(state.params))


if __name__ == "__main__":
    # each port variant's worst gradient leaf and loss gap against JAX's
    # mixed step (the readings in the docstring; set XLA_FLAGS to compare)
    for mode in ("forward", "lsa"):
        for name, res in _tacotron_runs(mode).items():
            print(f"tacotron {mode} {name}: gradients {P.grad_error(res):.3g} of max|g|, "
                  f"loss {abs(res['loss'] - res['jloss']) / abs(res['jloss']):.3g}")
    for mode in ("RAW", "MOL"):
        for mixed in (True, False):
            jl, jg, _, tl, _, tg = _wavernn_grads(mode, mixed)[:6]
            print(f"wavernn {mode} {'mixed' if mixed else 'f32'}: gradients {_wavernn_grad_error(jg, tg):.3g} "
                  f"of max|g|, loss {abs(float(tl) - float(jl)) / abs(float(jl)):.3g}")
