"""The port's command-line entry points, each driven through its
``main(argv)`` on ``--device cpu`` at a tiny width: the export CLI (round
trip through npz files and through checkpoint directories, and its
argument errors), the server's ``--override`` over an artifact's config
with a Griffin-Lim artifact answering requests, the server started from
checkpoint directories (``--ckpt-dir``, exclusive with ``--export-dir``),
the synthesis CLI, the
WaveRNN CLI on a ``.npy`` mel and on a ``.wav``, and ``FileNotFoundError``
for an empty checkpoint directory wherever one can be named."""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import urllib.request
import wave

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.dsp import spectrogram as S
from tacotronv2_wavernn_chinese_tpu_torch.infer import synthesize as SYN_CLI
from tacotronv2_wavernn_chinese_tpu_torch.infer import wavernn_gen as WG
from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer
from tacotronv2_wavernn_chinese_tpu_torch.serving import export as EX
from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import (
    CheckpointManager,
    init_tacotron,
    init_wavernn,
    load_params_npz,
    save_params_npz,
)

TINY = ("tacotron.embedding_dim=16,tacotron.enc_conv_channels=16,tacotron.enc_conv_layers=1,"
        "tacotron.encoder_lstm_units=8,tacotron.attention_dim=8,tacotron.attention_filters=4,"
        "tacotron.attention_kernel=5,tacotron.prenet_layers=(8,8),tacotron.decoder_lstm_units=8,"
        "tacotron.postnet_channels=8,tacotron.postnet_layers=1")
VOC = ("wavernn.upsample_factors=(2,2,5),wavernn.rnn_dims=32,wavernn.fc_dims=32,wavernn.compute_dims=16,"
       "wavernn.res_out_dims=128,wavernn.res_blocks=1,audio.hop_size=20,audio.bits=8,"
       "wavernn_gen.target=200,wavernn_gen.overlap=40")
STEPS = 6  # decode steps: the stop bias is -30, so every decode runs max_iters
TEXT = "你好。"


def _taco(cfg, bias=-30.0):
    p = init_tacotron(0, cfg.tacotron)
    p["stop_projection"]["b"] = torch.full_like(p["stop_projection"]["b"], bias)
    return p


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Tiny Tacotron (stop bias -30) and WaveRNN weights as npz files and
    as checkpoint directories."""
    root = tmp_path_factory.mktemp("weights")
    cfg = default_config().override(TINY + "," + VOC)
    taco, voc = _taco(cfg), init_wavernn(1, cfg.wavernn, num_mels=80, bits=8)
    paths = {"taco_npz": str(root / "taco.npz"), "voc_npz": str(root / "voc.npz"),
             "taco_ckpt": str(root / "taco_ckpt"), "voc_ckpt": str(root / "voc_ckpt")}
    save_params_npz(paths["taco_npz"], taco)
    save_params_npz(paths["voc_npz"], voc)
    CheckpointManager(paths["taco_ckpt"]).save(3, taco, {})
    CheckpointManager(paths["voc_ckpt"]).save(5, voc, {})
    return cfg, taco, voc, paths


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(torch.as_tensor(a)), np.asarray(torch.as_tensor(b)))


@pytest.mark.parametrize("source", ["npz", "ckpt"])
def test_export_cli_round_trip(weights, tmp_path, source):
    cfg, taco, voc, paths = weights
    out = str(tmp_path / "artifact")
    argv = (["--params-npz", paths["taco_npz"], "--wavernn-params-npz", paths["voc_npz"]] if source == "npz"
            else ["--ckpt-dir", paths["taco_ckpt"], "--wavernn-ckpt-dir", paths["voc_ckpt"]])
    EX.main(argv + ["--out", out, "--override", TINY + "," + VOC])
    assert sorted(os.listdir(out)) == ["MANIFEST.json", "config.json", "symbols.txt", "tacotron_params.npz",
                                       "wavernn_params.npz"]
    _equal_trees(load_params_npz(os.path.join(out, "tacotron_params.npz")), taco)
    _equal_trees(load_params_npz(os.path.join(out, "wavernn_params.npz")), voc)
    synth = EX.load_exported(out, device="cpu")
    assert synth.cfg == cfg and synth.vocoder_params is not None
    _equal_trees(synth.params, taco)


@pytest.mark.parametrize("argv,message", [
    ([], "one of --ckpt-dir / --params-npz is required"),
    (["--ckpt-dir", "a", "--params-npz", "b"], "mutually exclusive"),
    (["--params-npz", "a", "--wavernn-ckpt-dir", "b", "--wavernn-params-npz", "c"], "mutually exclusive"),
])
def test_export_cli_argument_errors(capsys, argv, message):
    with pytest.raises(SystemExit):
        EX.main(argv + ["--out", "never-written"])
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("entry", ["from_checkpoints", "from_checkpoints_wavernn", "export", "synthesize",
                                   "wavernn_gen", "missing_dir", "server"])
def test_empty_checkpoint_dir_raises(weights, tmp_path, entry):
    """An empty directory raises FileNotFoundError; a named WaveRNN
    directory never falls back to Griffin-Lim."""
    cfg, _, _, paths = weights
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    mel = str(tmp_path / "mel.npy")
    np.save(mel, np.full((4, 80), 0.5, np.float32))
    calls = {
        "from_checkpoints": lambda: Synthesizer.from_checkpoints(cfg, empty, device="cpu"),
        "from_checkpoints_wavernn": lambda: Synthesizer.from_checkpoints(cfg, paths["taco_ckpt"], empty,
                                                                         device="cpu"),
        "export": lambda: EX.main(["--ckpt-dir", empty, "--out", str(tmp_path / "out")]),
        "synthesize": lambda: SYN_CLI.main(["--params-npz", paths["taco_npz"], "--wavernn-ckpt-dir", empty,
                                            "--text", TEXT, "--override", TINY, "--device", "cpu"]),
        "wavernn_gen": lambda: WG.main(["--file", mel, "--ckpt-dir", empty, "--device", "cpu"]),
        "missing_dir": lambda: Synthesizer.from_checkpoints(cfg, str(tmp_path / "nowhere"), device="cpu"),
        "server": lambda: SRV.main(["--ckpt-dir", paths["taco_ckpt"], "--wavernn-ckpt-dir", empty,
                                    "--override", TINY + "," + VOC, "--device", "cpu", "--no-warmup"]),
    }
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        calls[entry]()
    assert not os.path.exists(str(tmp_path / "nowhere"))


def test_from_checkpoints_restores_the_step(weights, tmp_path):
    cfg, taco, voc, paths = weights
    synth = Synthesizer.from_checkpoints(cfg, paths["taco_ckpt"], paths["voc_ckpt"], step=3, device="cpu")
    _equal_trees(synth.params, taco)
    _equal_trees(synth.vocoder_params, voc)
    with pytest.raises(FileNotFoundError):
        Synthesizer.from_checkpoints(cfg, paths["taco_ckpt"], step=4, device="cpu")


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _frames(b64):
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        return w.getnframes()


def test_server_override_and_griffin_lim_artifact(weights, tmp_path, monkeypatch):
    """A Griffin-Lim artifact (no WaveRNN weights) written at max_iters 2000
    and 60 iterations; the server CLI's ``--override`` caps the decode at
    STEPS steps and the reconstruction at 4 iterations.  The CLI's server
    is captured and closed at once; a server on its synthesizer answers
    both endpoints with WAVs of stop_len x hop samples."""
    cfg = default_config().override(TINY)
    art = str(tmp_path / "gl_artifact")
    EX.write_artifact(cfg, _taco(cfg), art)
    real_serve, seen = SRV.serve, {}

    def serve(*a, **kw):
        httpd = real_serve(*a, **kw)
        httpd.serve_forever = lambda: None
        seen["httpd"] = httpd
        return httpd

    monkeypatch.setattr(SRV, "serve", serve)
    SRV.main(["--export-dir", art, "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--no-warmup",
              "--override", f"tacotron.max_iters={STEPS},audio.griffin_lim_iters=4"])
    synth = seen["httpd"].service.synth
    assert synth.cfg.tacotron.max_iters == STEPS and synth.cfg.audio.griffin_lim_iters == 4
    assert synth.max_iters == STEPS and synth.vocoder_params is None
    with open(os.path.join(art, "config.json"), encoding="utf-8") as f:
        assert json.load(f)["tacotron"]["max_iters"] == cfg.tacotron.max_iters
    httpd = real_serve(synth.cfg, synth, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        SRV.warmup(synth, 2)
        port = httpd.server_address[1]
        one = _post(port, "/generate_tts", {"text": TEXT, "seed": 1})
        assert one["status"] == 0 and _frames(one["wav_b64"]) == STEPS * 275
        many = _post(port, "/generate_tts_batch", {"texts": [TEXT, "今天天气很好。", "再见。"], "seed": 2})
        assert many["status"] == 0 and [_frames(r["wav_b64"]) for r in many["results"]] == [STEPS * 275] * 3
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["vocoder"] == "griffin_lim" and health["requests"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def _captured_server(monkeypatch):
    """Make ``server.serve`` return its server with a ``serve_forever``
    that returns at once; -> (the real ``serve``, dict the server lands in)."""
    real_serve, seen = SRV.serve, {}

    def serve(*a, **kw):
        httpd = real_serve(*a, **kw)
        httpd.serve_forever = lambda: None
        seen["httpd"] = httpd
        return httpd

    monkeypatch.setattr(SRV, "serve", serve)
    return real_serve, seen


@pytest.mark.parametrize("vocoder", ["griffin_lim", "wavernn"])
def test_server_from_checkpoint_dirs(weights, monkeypatch, vocoder):
    """``--ckpt-dir`` (and ``--wavernn-ckpt-dir``) start the server from the
    trainers' checkpoint directories under the default config plus
    ``--override``: the restored weights equal the saved ones, and one
    /generate_tts answers with a WAV of STEPS frames x hop samples."""
    cfg, taco, voc, paths = weights
    real_serve, seen = _captured_server(monkeypatch)
    argv = ["--ckpt-dir", paths["taco_ckpt"], "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
            "--no-warmup", "--max-iters", str(STEPS), "--override", TINY + "," + VOC]
    if vocoder == "wavernn":
        argv += ["--wavernn-ckpt-dir", paths["voc_ckpt"]]
    SRV.main(argv)
    seen["httpd"].server_close()
    synth = seen["httpd"].service.synth
    assert synth.cfg == cfg and synth.max_iters == STEPS
    _equal_trees(synth.params, taco)
    if vocoder == "wavernn":
        _equal_trees(synth.vocoder_params, voc)
    else:
        assert synth.vocoder_params is None
    httpd = real_serve(synth.cfg, synth, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_address[1]
        one = _post(port, "/generate_tts", {"text": TEXT, "seed": 1})
        assert one["status"] == 0 and _frames(one["wav_b64"]) == STEPS * cfg.audio.hop_size
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["vocoder"] == vocoder
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


@pytest.mark.parametrize("argv,message", [
    ([], "exactly one of --export-dir / --ckpt-dir is required"),
    (["--export-dir", "a", "--ckpt-dir", "b"], "exactly one of --export-dir / --ckpt-dir is required"),
    (["--export-dir", "a", "--wavernn-ckpt-dir", "b"], "--wavernn-ckpt-dir goes with --ckpt-dir"),
])
def test_server_cli_argument_errors(capsys, argv, message):
    with pytest.raises(SystemExit):
        SRV.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def test_synthesize_cli_writes_griffin_lim_wav(weights, tmp_path):
    _, _, _, paths = weights
    out = str(tmp_path / "out")
    r = SYN_CLI.main(["--params-npz", paths["taco_npz"], "--text", TEXT, "--out-dir", out, "--device", "cpu",
                      "--override", TINY + f",tacotron.max_iters={STEPS},audio.griffin_lim_iters=4"])
    assert os.path.dirname(r["paths"]["wav"]) == out and os.path.basename(r["paths"]["wav"]).startswith("wav-")
    sr, pcm = wavfile.read(r["paths"]["wav"])
    assert sr == 22050 and pcm.dtype == np.int16 and pcm.shape == (STEPS * 275,)
    mel = np.load(r["paths"]["mel"])
    assert mel.shape == (STEPS, 80) and mel.min() >= 0.0 and mel.max() <= 1.0


@pytest.mark.parametrize("flags,hops", [([], 10), (["--unbatched"], 10), (["--target", "100", "--overlap", "0"], 10)])
def test_wavernn_gen_cli_on_npy(weights, tmp_path, flags, hops):
    cfg, _, _, paths = weights
    mel = str(tmp_path / "utt.npy")
    np.save(mel, np.random.default_rng(0).uniform(0.0, 1.0, (hops, 80)).astype(np.float32))
    out = WG.main(["--file", mel, "--params-npz", paths["voc_npz"], "--override", VOC, "--device", "cpu",
                   "--output", str(tmp_path / "o.wav"), *flags])
    sr, pcm = wavfile.read(out)
    assert sr == 22050 and pcm.shape == (hops * cfg.audio.hop_size,)


def test_wavernn_gen_cli_on_wav(weights, tmp_path, monkeypatch):
    """A .wav goes through MelPipeline.melspectrogram and mel_to_unit."""
    cfg, _, _, paths = weights
    src = str(tmp_path / "speech.wav")
    wavfile.write(src, 22050, (0.3 * np.sin(np.arange(400) * 0.07)).astype(np.float32))
    seen = {}

    def spy(cfg_, params, mel, out_path, seed=0, device=None):
        seen["mel"] = mel
        return out_path

    monkeypatch.setattr(WG, "gen_from_mel", spy)
    monkeypatch.chdir(tmp_path)
    out = WG.main(["--file", src, "--params-npz", paths["voc_npz"], "--override", VOC, "--device", "cpu"])
    assert out == "speech_batched_t200_o40.wav"
    want = S.mel_to_unit(S.MelPipeline(cfg.audio, "cpu").melspectrogram(WG.load_wav(src, 22050)).numpy(), cfg.audio)
    np.testing.assert_array_equal(seen["mel"], want.astype(np.float32))
    assert seen["mel"].shape == (S.num_frames(400, cfg.audio.n_fft, 20), 80)


@pytest.mark.parametrize("mel,message", [(np.zeros((4, 79), np.float32), "expected"),
                                         (np.full((4, 80), 1.5, np.float32), "unit"),
                                         (np.zeros(80, np.float32), "expected")])
def test_gen_from_mel_checks_the_mel(weights, tmp_path, mel, message):
    cfg, _, voc, _ = weights
    with pytest.raises(ValueError, match=message):
        WG.gen_from_mel(cfg, voc, mel, str(tmp_path / "x.wav"), device="cpu")
