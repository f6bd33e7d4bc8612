"""The slice end to end: an artifact written by the JAX package's exporter
is loaded by the port on the CPU and synthesizes the same mels and wavs as
the JAX package's forward_inference + generate_batch; the port's server
answers both endpoints with valid WAVs."""

import base64
import dataclasses
import functools
import io
import json
import threading
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.dsp.spectrogram import mel_to_unit
from tacotronv2_wavernn_chinese_tpu.frontend import default_symbols, get_pyin
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu.models import wavernn as JW
from tacotronv2_wavernn_chinese_tpu.serving.export import export_artifact
from tacotronv2_wavernn_chinese_tpu_torch.config import _config_from_dict as port_config
from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer
from tacotronv2_wavernn_chinese_tpu_torch.serving import server as TS
from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported

TEXTS = ["你好。", "今天天气很好。", "这是第3个句子。"]
MAX_ITERS = 24
HOP = 20


def _cfg():
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        tacotron=dataclasses.replace(
            cfg.tacotron, embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2,
            encoder_lstm_units=32, attention_dim=16, attention_filters=8, attention_kernel=7,
            prenet_layers=(32, 32), decoder_lstm_units=32, postnet_channels=32,
            postnet_layers=2, dropout_rate=0.0,
        ),
        wavernn=dataclasses.replace(
            cfg.wavernn, upsample_factors=(2, 2, 5), rnn_dims=32, fc_dims=32,
            compute_dims=16, res_out_dims=128, res_blocks=1,
        ),
        wavernn_gen=dataclasses.replace(cfg.wavernn_gen, target=200, overlap=40),
        audio=dataclasses.replace(cfg.audio, hop_size=HOP, bits=8),
    )


@pytest.fixture(scope="module")
def weights():
    """JAX weights, made once for both artifacts (jitted: one compile
    instead of one per eager op, same values)."""
    cfg = _cfg()
    params = jax.jit(lambda k: JT.init_tacotron(k, cfg.tacotron))(jax.random.PRNGKey(0))
    voc = jax.jit(lambda k: JW.init_wavernn(k, cfg.wavernn, num_mels=80, bits=8))(jax.random.PRNGKey(1))
    return cfg, params, voc


@pytest.fixture(scope="module", params=[None, -30.0], ids=["normal_bias", "runs_to_max_iters"])
def artifact(request, weights, tmp_path_factory):
    cfg, params, voc = weights
    params = dict(params)
    if request.param is not None:
        sp = params["stop_projection"]
        params["stop_projection"] = dict(sp, b=jnp.full_like(sp["b"], request.param))
    path = str(tmp_path_factory.mktemp("artifact"))
    export_artifact(cfg, params, path, voc)
    return cfg, params, voc, path, request.param


def _jax_reference(cfg, params, voc):
    sym = default_symbols()
    ids = [sym.encode(get_pyin(t)[0]) for t in TEXTS]
    inputs, lens = Synthesizer._pad_ids(ids)
    out = JT.forward_inference(params, cfg.tacotron, jnp.asarray(inputs),
                               jnp.asarray(np.asarray(lens, np.int32)), jax.random.PRNGKey(0), MAX_ITERS)
    stop = np.asarray(out.stop_lengths)
    mels = [np.asarray(out.mel_outputs)[i, : stop[i]] for i in range(len(TEXTS))]
    units = [mel_to_unit(m, cfg.audio, xp=np) for m in mels]
    wavs = JW.generate_batch(voc, cfg.wavernn, cfg.wavernn_gen, units, jax.random.PRNGKey(0), bits=8,
                             generate_fn=functools.partial(JW.generate_scan, greedy=True))
    return stop, mels, wavs


def test_synthesize_batch_matches_jax(artifact):
    cfg, params, voc, path, bias = artifact
    synth = load_exported(path, max_iters=MAX_ITERS, device="cpu")
    synth.greedy = True
    res = synth.synthesize_batch(TEXTS, seed=[1, 2, 3])
    stop, mels, wavs = _jax_reference(cfg, params, voc)
    assert [r["mel"].shape[0] for r in res] == stop.tolist()
    if bias is not None:
        assert stop.tolist() == [MAX_ITERS] * 3
    for r, m, w in zip(res, mels, wavs):
        np.testing.assert_allclose(r["mel"], m, atol=1e-4)
        assert r["wav"].shape == (m.shape[0] * HOP,)
        np.testing.assert_allclose(r["wav"], np.asarray(w), atol=1e-5)


def test_row_independence(artifact):
    """With dropout on (0.5, per-row seeds), a row decoded alone equals the
    same row in a batch of 3."""
    cfg, _, _, path, _ = artifact
    base = load_exported(path, max_iters=MAX_ITERS, device="cpu")
    cfg5 = dataclasses.replace(base.cfg, tacotron=dataclasses.replace(base.cfg.tacotron, dropout_rate=0.5))
    synth = Synthesizer(cfg5, base.params, base.vocoder_params, max_iters=MAX_ITERS,
                        symbols=base.symbols, device="cpu")
    ids = [synth.symbols.encode(get_pyin(t)[0]) for t in TEXTS]
    mels, _, stops = synth.mel_from_ids(ids, seed=[4, 5, 6])
    alone, _, stop1 = synth.mel_from_ids([ids[1]], seed=[5])
    assert stop1[0] == stops[1]
    np.testing.assert_allclose(alone[0], mels[1], atol=1e-5)


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _wav_frames(b64):
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        return w.getnframes()


def test_server_answers_both_endpoints(artifact):
    _, _, _, path, bias = artifact
    synth = load_exported(path, max_iters=MAX_ITERS, device="cpu")
    httpd = TS.serve(synth.cfg, synth, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_address[1]
        one = _post(port, "/generate_tts", {"text": TEXTS[0], "seed": 1})
        assert one["status"] == 0 and one["pyin"].startswith("n i3 h ao3")
        n = _wav_frames(one["wav_b64"])
        many = _post(port, "/generate_tts_batch", {"texts": TEXTS, "seed": 2})
        assert many["status"] == 0 and len(many["results"]) == 3
        ns = [_wav_frames(r["wav_b64"]) for r in many["results"]]
        if bias is not None:
            assert n == MAX_ITERS * HOP and ns == [MAX_ITERS * HOP] * 3
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["vocoder"] == "wavernn" and health["requests"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


def test_griffin_lim_path_raises(artifact):
    cfg, params, _, _, _ = artifact
    synth = Synthesizer(port_config(cfg.to_dict()), jax.device_get(params), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        synth.synthesize(TEXTS[0])
    assert isinstance(synth.params["embedding"], torch.Tensor)
