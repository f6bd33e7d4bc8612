"""The plain reference held to the port at small widths on the CPU (the
test imports both; the reference imports nothing of the port)."""

import numpy as np
import torch

from benchmark import portcfg
from benchmark.reference import griffin_lim as RG
from benchmark.reference import tacotron as RT
from benchmark.reference import wavernn as RW
from benchmark.weights import make_params, with_stop_bias

from .conftest import TINY


def setup(vocoder=True):
    from benchmark import core

    conf = core.load_json(f"{core.HERE}/configs/tacotron2-fwd-wavernn-raw10.json")
    cfg = portcfg.build(conf, TINY)
    sections = {s: portcfg.section(conf, s, TINY) for s in portcfg.SECTIONS}
    return cfg, sections


def test_decoder_and_postnet_match_the_port():
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    cfg, sec = setup()
    p = with_stop_bias(make_params(init_tacotron(0, cfg.tacotron, device="meta"), 3, "cpu"), -30.0)
    ids = torch.tensor([[5, 9, 30, 7, 2, 11, 190], [4, 8, 15, 16, 23, 0, 0]])
    lens = torch.tensor([7, 5])
    out = T.forward_inference(p, cfg.tacotron, ids, lens, [2**31 + 9, 77], 12)
    for b, seed in enumerate([2**31 + 9, 77]):
        mem = RT.encode(p, sec["tacotron"], ids[b], int(lens[b]))
        fr, _, al = RT.decode_teacher_forced(p, sec["tacotron"], mem, int(lens[b]), out.decoder_output[b], seed)
        assert torch.allclose(fr, out.decoder_output[b], atol=1e-5)
        assert torch.allclose(al, out.alignments[b], atol=1e-5)
        mel = RT.postnet(p, sec["tacotron"], out.decoder_output[b])
        assert torch.allclose(mel, out.mel_outputs[b], atol=1e-5)


def test_vocoder_gap_is_zero_on_the_ports_labels():
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W
    from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as K
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn

    cfg, sec = setup()
    vp = make_params(init_wavernn(0, cfg.wavernn, 80, 10, device="meta"), 4, "cpu")
    mel = np.random.default_rng(0).uniform(-4, 4, (8, 80)).astype(np.float32)
    folds = torch.as_tensor(RW.fold_mels(mel, sec["wavernn"], sec["wavernn_gen"], 4.0))
    cond = W.precompute_conditioning(vp, cfg.wavernn, folds)
    labels = K.sample_labels_plain(cond, K.pack_weights(vp, cfg.wavernn), 2**31 + 1).t()
    with torch.no_grad():
        hid = RW.hidden(vp, sec["wavernn"], folds, labels, 10)
        z = RW.perturbed_logits(vp, hid, 0, labels.shape[1], 2**31 + 1, 0, 10)
    assert float(RW.gap_below_best(z, labels).detach().max()) < 1e-5
    wav = W.generate_batch(vp, cfg.wavernn, cfg.wavernn_gen, [RW.unit_mel(mel, 4.0)], 2**31 + 1)[0]
    ref = RW.fade_out(RW.crossfade(RW.mu_law_expand(labels, 10).numpy(), 275)[: len(wav)], 275)
    assert np.abs(ref - wav).max() < 1e-6


def test_griffin_lim_matches_the_port():
    from tacotronv2_wavernn_chinese_tpu_torch.dsp import spectrogram as S
    from tacotronv2_wavernn_chinese_tpu_torch.dsp.griffin_lim import inv_mel_spectrogram

    cfg, sec = setup()
    import dataclasses

    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, griffin_lim_iters=3))
    ac = dict(sec["audio"], griffin_lim_iters=3)
    mel = np.random.default_rng(1).uniform(-4, 1, (20, 80)).astype(np.float32)
    T_pad = 64
    padded = np.full((T_pad, 80), -4.0, np.float32)
    padded[:20] = mel
    got = inv_mel_spectrogram(padded[None], S.MelPipeline(cfg.audio, "cpu"))[0][: 20 * 275]
    ref = RG.reconstruct([mel], ac, "cpu", 20)[0]
    assert np.abs(ref - got).max() / np.abs(ref).max() < 1e-4


def test_training_step_matches_the_port():
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron
    from benchmark.compare import train_tacotron as CT

    cfg, sec = setup()
    p = make_params(init_tacotron(0, cfg.tacotron, device="meta"), 5, "cpu")
    rng = np.random.default_rng(2)
    B, T_in, T_out = 3, 16, 32
    batch = {"inputs": torch.as_tensor(rng.integers(1, 190, (B, T_in))), "input_lengths": torch.tensor([16, 9, 5]),
             "mel_targets": torch.as_tensor(rng.uniform(-4, 4, (B, T_out, 80)).astype(np.float32)),
             "stop_targets": torch.zeros(B, T_out), "target_lengths": torch.tensor([32, 20, 11]),
             "loss_frames": torch.full((B,), 32)}
    gen = torch.Generator().manual_seed(123)
    state, metrics = task.train_step(task.TrainState(0, p, task.adam_init(p)), batch, gen, cfg)
    ref = CT.reference_steps(sec, p, [batch], [123], "cpu")
    assert abs(ref["losses"][0] - metrics["loss"]) < 1e-5 * abs(metrics["loss"])
    for path, v in CT.leaves(state.params):
        assert torch.allclose(ref["params"][path], v, atol=1e-6), path


def test_frontend_matches_the_port():
    """The reference frontend and the port's G2P give the same phonemes for
    the serving mixes' texts and for numbers read out in hanzi."""
    from benchmark import core, traffic_gen
    from benchmark.reference import frontend as RF
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.frontend.normalize import int_to_words

    tr = core.load_traffic("serve-poisson-wavernn", core.ROOT)
    texts = [r["text"] for seed in (1, 2**31 + 11) for r in traffic_gen.serve_schedule(tr, seed, 20.0)]
    texts += ["3.5元，共12.25万！", "“引号”：测试……好！", "《书名》、顿号—破折号；分号", "ni3 hao3，pi1 bi1", tr["warmup_text"]]
    assert [RF.phonemes(t) for t in texts] == [get_pyin(t)[0] for t in texts]
    numbers = [str(n) for n in list(range(0, 1200)) + [10000, 10010, 100001, 20000300, 10**12 + 7, 10**17 + 3]]
    assert [RF.read_integer(n) for n in numbers] == [int_to_words(n) for n in numbers]
