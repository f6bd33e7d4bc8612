"""HiFi-GAN V1 (``benchmark/configs/hifigan-v1.json``) in the port, on the
CPU at small widths: the generator, the discriminators, the mel and whole
GAN steps of ``train.hifigan_task`` held to the benchmark's plain reference
(``benchmark/reference/hifigan.py``: torch's own modules, weight and
spectral norm and AdamW) on seeded random weights; the decoupled decay of
the one Adam against ``torch.optim.AdamW`` and, at decay 0, against the
Adam it was before; the C++ sampler's segments; the CLI's checkpoints; and
the generator's work count at the published widths.

Tolerances: the two sides run the same float32 operations but in other
orders (torch's fused weight-norm and ``torch.stft`` against the port's
``vector_norm`` and framed ``rfft``, autograd's sums of a tensor's
gradients in another order), so what is compared is held to a few hundred
times float32's rounding (1.2e-7) of its scale, as each test says."""

import dataclasses
import os
import sys
import wave

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402
from benchmark.compare import train_hifigan as CMP  # noqa: E402
from benchmark.drivers import train_hifigan as DRV  # noqa: E402
from benchmark.reference import hifigan as RH  # noqa: E402
from benchmark.work import hifigan as WH  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.data.native_loader import NativeSegmentLoader, peak_gains  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.dsp.spectrogram import hifigan_mel, mel_basis  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.models import hifigan as H  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_task as task  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_train as HT  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.train import optim  # noqa: E402

CONF = core.load_json(os.path.join(ROOT, "benchmark", "configs", "hifigan-v1.json"))
# small widths; every kernel, stride, group, period and dilation as published
TINY = {"hifigan": {"upsample_initial_channel": 32, "mpd_channels": [4, 8, 16, 32, 32],
                    "msd_channels": [16, 16, 32, 32, 64, 64, 64]},
        "hifigan_train": {"batch_size": 2, "segment_size": 2048}}
SEED = 2**33 + 29


@pytest.fixture(scope="module")
def setup():
    cfg = DRV.port_config(CONF, TINY)
    conf = DRV.sections(CONF, TINY)
    params, sn = DRV.weights(cfg, SEED, "cpu")
    audio = torch.clamp(torch.randn(2, 2048, generator=torch.Generator().manual_seed(5)) * 0.1, -1, 1)
    return cfg, conf, params, sn, audio


def _close(a, b, rel):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) <= rel * max(scale, 1e-30)


def test_the_configuration_is_the_ports_default():
    """The published widths are the port's defaults; nothing was cut."""
    cfg = DRV.port_config(CONF)
    assert cfg.hifigan == default_config().hifigan and CONF["reduced"] == []
    d = default_config().hifigan_train
    assert dataclasses.replace(cfg.hifigan_train, total_steps=d.total_steps) == d


def test_forwards_and_feature_maps_match_the_reference(setup):
    """Generator, MPD and MSD outputs and every feature map, with the
    spectral norm's u advanced alike (a map to 2e-5 of its largest
    element: a dozen convolutions deep, each summing up to 1,024 x 41
    products in another order)."""
    cfg, conf, params, sn, audio = setup
    gen, mpd, msd = RH.build(conf["hifigan"], params, sn, "cpu")
    h = cfg.hifigan
    mel = task.mel(h, audio)
    with torch.no_grad():
        y_port = H.generator(params["gen"], h, mel)
        y_ref = gen(mel)
        assert y_port.shape == (2, 1, 2048) and _close(y_port, y_ref, 2e-5)
        x = audio.unsqueeze(1)
        outs_p, fm_p = H.mpd(params["mpd"], x)
        r, g, fm_r, fm_g = mpd(x, y_ref)
        for a, b in zip(outs_p, r):
            assert _close(a, b, 2e-5)
        for fa, fb in zip(fm_p, fm_r):
            assert all(_close(a, b, 2e-5) for a, b in zip(fa, fb))
        outs_p, fm_p, sn1 = H.msd(params["msd"], sn, x)
        _, _, sn2 = H.msd(params["msd"], sn1, y_ref)
        r, g, fm_r, fm_g = msd(x, y_ref)
        for a, b in zip(outs_p, r):
            assert _close(a, b, 2e-5)
        for fa, fb in zip(fm_p, fm_r):
            assert all(_close(a, b, 2e-5) for a, b in zip(fa, fb))
        u_ref = RH.u_buffers(msd)
        assert all(_close(sn2["convs"][j], u_ref[("convs", j)], 1e-5) for j in range(7))


def test_weight_norm_is_per_input_channel_on_a_transposed_convolution():
    """torch's ``weight_norm(dim=0)`` on a ConvTranspose1d [in, out, k]
    weight norms each input channel: the port's ``wn_weight`` is torch's
    weight, and ``g`` has one entry an input channel."""
    m = RH._wn(torch.nn.ConvTranspose1d(6, 3, 4, 2))
    assert m.weight_g.shape == (6, 1, 1)
    with torch.no_grad():
        m.weight_g.mul_(torch.linspace(0.5, 2.0, 6).view(6, 1, 1))
        m(torch.zeros(1, 6, 5))  # the hook recomputes weight from g and v
    got = H.wn_weight({"g": m.weight_g.detach(), "v": m.weight_v.detach()})
    assert torch.allclose(got, m.weight, rtol=1e-6, atol=0)
    assert torch.allclose(torch.linalg.vector_norm(got, dim=(1, 2)), m.weight_g.detach().view(6), rtol=1e-6)


@pytest.mark.parametrize("length", [2047, 2050])
def test_mpd_reflect_pads_a_length_its_period_does_not_divide(setup, length):
    cfg, conf, params, sn, _ = setup
    ref = RH.DiscriminatorP(7, conf["hifigan"]["mpd_channels"])
    with torch.no_grad():
        for j, m in enumerate(ref.convs):
            for k, name in (("g", "weight_g"), ("v", "weight_v"), ("b", "bias")):
                getattr(m, name).copy_(params["mpd"][3]["convs"][j][k])
        for k, name in (("g", "weight_g"), ("v", "weight_v"), ("b", "bias")):
            getattr(ref.conv_post, name).copy_(params["mpd"][3]["conv_post"][k])
        x = torch.randn(2, 1, length, generator=torch.Generator().manual_seed(length)) * 0.1
        assert length % 7
        out_p, fm_p = H.period_disc(params["mpd"][3], x, 7)
        out_r, fm_r = ref(x)
    assert fm_p[0].shape[-2:] == fm_r[0].shape[-2:] and fm_p[0].shape[-1] == 7
    assert _close(out_p, out_r, 2e-5) and all(_close(a, b, 2e-5) for a, b in zip(fm_p, fm_r))


def test_the_mel_is_a_direct_stft_without_centring():
    """``hifigan_mel`` against ``torch.stft(center=False)`` on the same
    reflect-padded signal, with the magnitude, basis and log clamp written
    out (1e-5 of the largest log-mel: one FFT and one 513-term product)."""
    y = torch.randn(3, 4096, generator=torch.Generator().manual_seed(3)) * 0.2
    basis = torch.as_tensor(mel_basis(22050, 1024, 80, 0.0, 11025.0))
    got = hifigan_mel(y, basis, 1024, 256, 1024)
    pad = (1024 - 256) // 2
    yp = torch.nn.functional.pad(y.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
    spec = torch.stft(yp, 1024, 256, 1024, torch.hann_window(1024), center=False, return_complex=True)
    mag = torch.sqrt(spec.real**2 + spec.imag**2 + 1e-9)
    want = torch.log(torch.clamp(basis @ mag, min=1e-5))
    assert got.shape == (3, 80, 4096 // 256) and _close(got, want, 1e-5)
    assert _close(got, RH.mel_spectrogram(y, 1024, 80, 22050, 256, 1024, 0.0, 11025.0), 1e-5)


def test_gan_steps_match_the_reference(setup):
    """Two whole steps of the port (discriminators, then the generator
    through the updated discriminators, both AdamWs, u) against
    ``train.py``'s, read as the cell reads them: losses to 1e-5 relative,
    each network's first gradient and the updates after each step by the
    median leaf to 1e-4 of a leaf's norm, u to 1e-5."""
    cfg, conf, params, sn, audio = setup
    batches = [audio, audio.flip(0)]
    state = task.from_params(DRV.TC.clone(params), DRV.TC.clone(sn))
    prog = {"loss_d": [], "loss_g": [], "params": []}
    for i, b in enumerate(batches):
        state, m = task.train_step(state, {"audio": b}, cfg)
        prog["loss_d"].append(m["loss_disc"])
        prog["loss_g"].append(m["loss_gen"])
        prog["params"].append(DRV.TC.clone({"gen": state.gen.params, **state.disc.params}))
        if i == 0:
            prog["mu1_g"] = DRV.TC.clone(state.gen.opt_state["mu"])
            prog["mu1_d"] = DRV.TC.clone(state.disc.opt_state["mu"])
    prog["sn"] = state.sn
    vals = CMP.readings(conf, params, sn, batches, "cpu", prog)
    assert vals["loss_gap"] < 1e-5, vals
    assert vals["grad_gap_median_d"] < 1e-4 and vals["grad_gap_median_g"] < 1e-4, vals
    assert vals["update_gap_median"] < 1e-4 and vals["u_gap"] < 1e-5, vals
    # the parameters moved, and the discriminators' state advanced four times a step
    assert state.step == 2 and not torch.equal(state.gen.params["conv_pre"]["v"], params["gen"]["conv_pre"]["v"])


def test_adam_with_decay_is_torchs_adamw_and_without_it_the_adam_before():
    """``optim.adam`` with ``weight_decay`` against ``torch.optim.AdamW``
    over three steps (1e-6 of a parameter: the decay and the update are
    added in another order); at decay 0 bit for bit the Adam the trainers
    ran before the argument existed."""
    g = torch.Generator().manual_seed(11)
    p0 = {"a": torch.randn(5, 4, generator=g), "b": [torch.randn(3, generator=g)]}
    grads = [{"a": torch.randn(5, 4, generator=g), "b": [torch.randn(3, generator=g)]} for _ in range(3)]
    lr, b1, b2, eps, wd = 2e-4, 0.8, 0.99, 1e-8, 0.01
    ts = optim.TrainState(0, DRV.TC.clone(p0), optim.adam_init(p0))
    ref = [t.clone().requires_grad_(True) for t in (p0["a"], p0["b"][0])]
    opt = torch.optim.AdamW(ref, lr, betas=(b1, b2), eps=eps, weight_decay=wd, foreach=False)
    for gr in grads:
        ts, _ = optim.optimizer_step(ts, ts.params, gr, None, optim.optax_rule, lr, b1, b2, eps, weight_decay=wd)
        ref[0].grad, ref[1].grad = gr["a"], gr["b"][0]
        opt.step()
    assert torch.allclose(ts.params["a"], ref[0].detach(), rtol=0, atol=1e-6 * float(p0["a"].abs().max()))
    assert torch.allclose(ts.params["b"][0], ref[1].detach(), rtol=0, atol=1e-6 * float(p0["b"][0].abs().max()))

    def adam_before(grads, state, rule, lr, b1, b2, eps):
        count = state["count"] + 1
        update = rule(count, lr, b1, b2, eps)

        def leaf(g, m, v):
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * (g * g))
            return update(m, v)

        return optim.tree_map(leaf, grads, state["mu"], state["nu"])

    for rule in (optim.tf1_rule, optim.optax_rule):
        s1, s2 = optim.adam_init(p0), optim.adam_init(p0)
        for gr in grads:
            u1, s1 = optim.adam(gr, s1, rule, 1e-3, 0.9, 0.999, 1e-6, 0.0, p0)
            u2 = adam_before(gr, s2, rule, 1e-3, 0.9, 0.999, 1e-6)
            s2 = dict(s2, count=s2["count"] + 1)
            assert torch.equal(u1["a"], u2["a"]) and torch.equal(u1["b"][0], u2["b"][0])


def test_the_segment_sampler_cuts_each_utterance_at_its_gain():
    """Every segment is a slice of one utterance times its peak gain
    (0.95 / its largest |sample|), each utterance once an epoch."""
    rng = np.random.default_rng(4)
    audio = [np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16) for n in (5000, 7000, 6100, 9000)]
    gains = peak_gains(audio)
    assert np.allclose([np.abs(a).max() * gn for a, gn in zip(audio, gains)], 0.95, rtol=1e-6)
    loader = NativeSegmentLoader(audio, 4096, 2, n_workers=1, ring_size=2, seed=3)
    try:
        assert loader.num_utts == 4
        seen = []
        for _ in range(2):
            x = loader.next_batch().x
            assert x.shape == (2, 4096)
            for row in x:
                hits = [i for i, (a, gn) in enumerate(zip(audio, gains))
                        if any(np.array_equal(row, a[s:s + 4096] * gn)
                               for s in np.flatnonzero(a[:len(a) - 4096] * gn == row[0]))]
                assert len(hits) == 1
                seen += hits
        assert sorted(seen) == [0, 1, 2, 3]
    finally:
        loader.close()


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """``run_training`` on a corpus of .wav files: two steps, checkpoints,
    then a resume to three (the CLI's ``main``); a file at another rate is
    refused."""
    rng = np.random.default_rng(6)
    rows = []
    for i in range(4):
        pcm = np.clip(rng.normal(0, 3000, 3000 + 500 * i), -32768, 32767).astype(np.int16)
        with wave.open(str(tmp_path / f"a{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050 if i else 16000)
            w.writeframes(pcm.tobytes())
        rows.append(f"a{i}.wav|utt{i}")
    with pytest.raises(ValueError, match="16000 Hz"):
        HT.read_pcm(str(tmp_path / "a0.wav"), 22050)
    rows[0] = rows[1]
    (tmp_path / "train.txt").write_text("\n".join(rows) + "\n")
    over = ("hifigan.upsample_initial_channel=16,hifigan.mpd_channels=(4,8,8,16,16),"
            "hifigan.msd_channels=(16,16,16,16,32,32,32),hifigan_train.batch_size=2,"
            "hifigan_train.segment_size=2048,hifigan_train.checkpoint_every=2")
    args = ["--metadata", str(tmp_path / "train.txt"), "--data-dir", str(tmp_path), "--log-dir",
            str(tmp_path / "log"), "--override", over, "--device", "cpu"]
    assert HT.main(args + ["--steps", "2"]) == 0
    ckpts = sorted(os.listdir(tmp_path / "log" / "checkpoints"))
    assert ckpts == ["ckpt-2.pt"]
    assert HT.main(args + ["--steps", "3"]) == 0
    assert sorted(os.listdir(tmp_path / "log" / "checkpoints")) == ["ckpt-2.pt", "ckpt-3.pt"]


def test_the_generators_work_at_the_published_widths():
    """307,052,544 multiply-adds a mel frame (weights only, no biases):
    conv_pre 80 x 512 x 7, four transposed convolutions, 3 x 6 ResBlock1
    convolutions a stage at 256, 128, 64 and 32 channels, conv_post."""
    h = CONF["hifigan"]
    by_hand = 80 * 512 * 7 + 32 * 7 * 256
    ch, L = 512, 1
    for u, k in zip(h["upsample_rates"], h["upsample_kernel_sizes"]):
        by_hand += ch * (ch // 2) * k * L
        ch, L = ch // 2, L * u
        by_hand += 6 * ch * ch * (3 + 7 + 11) * L
    assert WH.generator_macs_per_frame(h) == by_hand == 307_052_544
