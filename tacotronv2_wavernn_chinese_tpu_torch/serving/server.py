"""HTTP TTS serving on the port's Synthesizer.

One process: the HTTP handler calls the synthesizer directly, and
concurrent requests are micro-batched into one ``synthesize_batch`` call.
``POST /generate_tts`` is drop-in for reference clients (form-encoded
``txt`` in, ``{txt, pyin, wav, img}`` data-URI fields out) and also speaks
JSON with explicit status/duration fields.

Endpoints:
  GET  /            demo page
  GET  /healthz     liveness + model info
  POST /generate_tts        form ``txt=...`` or JSON {"text": str, "seed"?: int}
  POST /generate_tts_batch  JSON {"texts": [str, ...], "seed"?: int}

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.serving.server \
        --export-dir export/1 [--port 8500] [--max-iters 1000]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import threading
import time
import wave as wave_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config import Config

_log = logging.getLogger(__name__)

_DEMO_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Chinese TTS</title></head>
<body style="font-family:sans-serif;max-width:640px;margin:2em auto">
<h2>Chinese TTS &mdash; Tacotron-2 + WaveRNN</h2>
<textarea id="t" rows="3" style="width:100%">你好，欢迎使用语音合成系统。</textarea>
<br><button onclick="go()">Synthesize</button> <span id="s"></span>
<div id="out"></div>
<script>
async function go(){
  const s=document.getElementById('s'); s.textContent='...';
  const r=await fetch('/generate_tts',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({text:document.getElementById('t').value})});
  const j=await r.json();
  if(j.status!==0){s.textContent='error: '+j.error;return;}
  s.textContent=j.duration_s.toFixed(2)+'s audio ('+j.pyin+')';
  document.getElementById('out').innerHTML=
    '<audio controls src="data:audio/wav;base64,'+j.wav_b64+'"></audio>'+
    '<br><img style="max-width:100%" src="data:image/png;base64,'+j.align_b64+'">';
}
</script></body></html>"""


def wav_to_base64(wav: np.ndarray, sample_rate: int) -> str:
    """float waveform -> base64 of an int16 WAV container, after the same
    post chain as saved files (dc-notch, peak normalize, 0.95-power
    companding, full-scale int16)."""
    from ..dsp.wav import postprocess_wav_int16

    pcm = postprocess_wav_int16(wav).astype("<i2") if wav.size else np.zeros(0, "<i2")
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _png_encode_rgb(img: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (struct + zlib): the serving hot path was
    paying ~140 ms/request for a matplotlib figure; this is ~2 ms.
    ``utils.plot`` (matplotlib) remains the eval-artifact renderer."""
    import struct
    import zlib

    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def alignment_to_base64_png(alignment: np.ndarray) -> str:
    """Alignment heatmap -> base64 PNG (reference website/app/plot.py:1-27).

    Pure-numpy viridis-like colormap + tiny PNG writer — thread-safe and
    ~70x faster per request than the matplotlib path."""
    a = np.asarray(alignment, np.float32)
    if a.size == 0:  # stop fired at frame 0 -> empty [0, T_in] slice
        return ""
    a = a / max(float(a.max()), 1e-9)
    # upscale (decoder steps x encoder pos) -> a readable image
    reps_y = max(1, 320 // max(a.shape[1], 1))
    reps_x = max(1, 480 // max(a.shape[0], 1))
    img_v = np.repeat(np.repeat(a.T[::-1], reps_y, axis=0), reps_x, axis=1)
    # compact viridis-ish gradient via 3 anchor colors
    anchors = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]], np.float32)
    t = np.clip(img_v, 0.0, 1.0) * 2.0
    lo = np.clip(t.astype(np.int32), 0, 1)
    frac = (t - lo)[..., None]
    rgb = anchors[lo] * (1 - frac) + anchors[lo + 1] * frac
    return base64.b64encode(
        _png_encode_rgb(rgb.astype(np.uint8))
    ).decode("ascii")


class OverloadedError(RuntimeError):
    """Raised when the admission queue is full; maps to HTTP 503."""

    def __init__(self, retry_after_s: float):
        super().__init__("server overloaded, queue full")
        self.retry_after_s = retry_after_s


class TTSService:
    """Holds the synthesizer; adaptively micro-batches device access.

    Concurrent ``/generate_tts`` requests that arrive while the device is
    busy are coalesced into ONE ``synthesize_batch`` call (padded acoustic
    decode + fused vocoder over all utterances' folds) instead of queueing
    serially behind a lock — the classic adaptive-batching server loop.
    The first request in an idle server runs immediately (no added
    latency).  Requests with DISTINCT seeds coalesce too: each row's decode
    noise depends only on its own seed, so a request's mel depends only on
    its own (text, seed), never on its co-batch.  The vocoder's
    category-sampling dither is drawn over the concatenated fold batch (see
    Synthesizer.synthesize_batch).  Different batch shapes sum in other
    orders, so floats can differ by ~1e-7 across batch sizes.

    Admission control: at most ``max_queue`` requests may wait (the
    reference fronted its model with TF Serving's bounded batch queue,
    website/README.md); beyond that ``generate`` raises ``OverloadedError``
    which the HTTP layer maps to 503 + Retry-After — bounded p95 instead of
    unbounded queue growth under overload.
    """

    def __init__(self, cfg: Config, synthesizer, max_batch: int = 8,
                 max_queue: int = 32, max_batch_hard: int | None = None):
        self.cfg = cfg
        self.synth = synthesizer
        self.max_batch = max_batch
        # depth-adaptive ceiling: when the queue is deeper than max_batch,
        # batches grow up to this bound so a backlog drains in fewer device
        # waves.  Round-4 measured the failure mode this fixes: at
        # concurrency 16 with a fixed max_batch=8, a request that just
        # missed a wave waited a FULL extra wave (p95/p50 3.4x vs 1.07x at
        # concurrency 8); padded-batch device time grows sublinearly with
        # rows, so one 16-row wave beats two 8-row waves on tail latency.
        self.max_batch_hard = max(max_batch, max_batch_hard or 2 * max_batch)
        self.max_queue = max_queue
        self._mutex = threading.Lock()  # guards the queue + counters
        self._device = threading.Lock()  # serializes device access (leader)
        self._queue: list[dict] = []
        self.n_requests = 0
        self.n_device_calls = 0
        self.n_rejected = 0
        # EMA of seconds per coalesced device call — the Retry-After hint
        self._batch_s_ema = 0.5

    # -- adaptive micro-batching ---------------------------------------------

    def _take_batch(self) -> list[dict]:
        """Pop the FIFO prefix.  Per-example PRNG keys mean any seed mix
        batches together (round 3 measured 2.4x throughput loss from the
        old same-seed-prefix rule under distinct-seed traffic).  The prefix
        length adapts to queue depth: <= max_batch normally, up to
        max_batch_hard when a backlog has formed (see __init__)."""
        with self._mutex:
            take = (self.max_batch if len(self._queue) <= self.max_batch
                    else min(len(self._queue), self.max_batch_hard))
            batch, self._queue = self._queue[:take], self._queue[take:]
            return batch

    def _run_batch(self, batch: list[dict]) -> None:
        t0 = time.time()
        try:
            if len(batch) == 1:
                results = [self.synth.synthesize(batch[0]["text"], seed=batch[0]["seed"])]
            else:
                results = self.synth.synthesize_batch(
                    [i["text"] for i in batch],
                    seed=[i["seed"] for i in batch],
                    pad_batch=True,
                )
            with self._mutex:
                self._batch_s_ema = 0.7 * self._batch_s_ema + 0.3 * (time.time() - t0)
                self.n_device_calls += 1
                self.n_requests += len(batch)
            for item, r in zip(batch, results):
                item["result"] = r
                item["done"].set()
        except Exception as e:  # noqa: BLE001 - delivered to each waiter
            for item in batch:
                item["error"] = e
                item["done"].set()

    def _pump(self) -> None:
        """Drain the queue as the leader if the device is idle."""
        if not self._device.acquire(blocking=False):
            return  # another thread is leading; our item rides its batch
        try:
            while True:
                batch = self._take_batch()
                if not batch:
                    return
                self._run_batch(batch)
        finally:
            self._device.release()

    def generate(self, text: str, seed: int = 0) -> dict:
        t0 = time.time()
        item = {
            "text": text,
            "seed": seed,
            "done": threading.Event(),
            "result": None,
            "error": None,
        }
        with self._mutex:
            if len(self._queue) >= self.max_queue:
                self.n_rejected += 1
                # hint: time to drain the queued batches at the current rate
                waves = -(-len(self._queue) // max(self.max_batch, 1))
                raise OverloadedError(round(max(0.1, waves * self._batch_s_ema), 1))
            self._queue.append(item)
        # re-pump on timeout: covers the race where the leader released the
        # device just before our item hit the queue
        self._pump()
        while not item["done"].wait(timeout=0.05):
            self._pump()
        if item["error"] is not None:
            raise item["error"]
        r = item["result"]
        wav, align, pyin = r["wav"], r["alignment"], r["pyin"]
        wav_b64 = wav_to_base64(wav, self.cfg.audio.sample_rate)
        align_b64 = alignment_to_base64_png(align)
        return {
            "status": 0,
            "pyin": pyin,
            "duration_s": float(len(wav) / self.cfg.audio.sample_rate),
            "synthesis_s": round(time.time() - t0, 3),
            "wav_b64": wav_b64,
            "align_b64": align_b64,
            # reference wire fields (views.py:94-103): data-URI wav/img + txt
            "txt": text,
            "wav": "data:audio/wav;base64, %s" % wav_b64,
            "img": "data:image/png;base64, %s" % align_b64,
        }

    def generate_many(self, texts: list[str], seed: int = 0) -> dict:
        """Batched endpoint: one acoustic decode + one fused vocoder call."""
        t0 = time.time()
        with self._device:
            results = self.synth.synthesize_batch(texts, seed=seed, pad_batch=True)
            with self._mutex:
                self.n_device_calls += 1
                self.n_requests += len(texts)
        sr = self.cfg.audio.sample_rate
        return {
            "status": 0,
            "synthesis_s": round(time.time() - t0, 3),
            "results": [
                {
                    "pyin": r["pyin"],
                    "duration_s": float(len(r["wav"]) / sr),
                    "wav_b64": wav_to_base64(r["wav"], sr),
                }
                for r in results
            ],
        }


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to logging, not stderr
            _log.debug("http: " + fmt, *args)

        def _json(self, code: int, payload: dict, headers: dict | None = None):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _DEMO_PAGE.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "requests": service.n_requests,
                        "device_calls": service.n_device_calls,
                        "rejected": service.n_rejected,
                        "max_batch": service.max_batch,
                        "max_queue": service.max_queue,
                        "vocoder": "wavernn" if service.synth.vocoder_params is not None else "griffin_lim",
                    },
                )
            else:
                self._json(404, {"status": 1, "error": "not found"})

        def do_POST(self):
            if self.path not in ("/generate_tts", "/generate_tts_batch"):
                self._json(404, {"status": 1, "error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) or b"{}"
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
                if ctype == "application/x-www-form-urlencoded":
                    # reference client contract: form field `txt` (views.py:56)
                    from urllib.parse import parse_qs

                    form = parse_qs(body.decode("utf-8"))
                    req = {"text": (form.get("txt") or form.get("text") or [""])[0]}
                else:
                    req = json.loads(body)
                if self.path == "/generate_tts_batch":
                    texts = [str(t).strip() for t in (req.get("texts") or [])]
                    texts = [t for t in texts if t]
                    if not texts:
                        self._json(400, {"status": 1, "error": "empty texts"})
                        return
                    if len(texts) > 64 or any(len(t) > 500 for t in texts):
                        self._json(400, {"status": 1, "error": "too many/long texts"})
                        return
                    self._json(200, service.generate_many(texts, seed=int(req.get("seed", 0))))
                    return
                text = (req.get("text") or "").strip()
                if not text:
                    self._json(400, {"status": 1, "error": "empty text"})
                    return
                if len(text) > 500:
                    self._json(400, {"status": 1, "error": "text too long (max 500 chars)"})
                    return
                self._json(200, service.generate(text, seed=int(req.get("seed", 0))))
            except OverloadedError as e:
                # bounded-queue admission control (TF Serving's role in the
                # reference deployment): shed load instead of queueing
                self._json(
                    503,
                    {"status": 1, "error": "overloaded", "retry_after_s": e.retry_after_s},
                    headers={"Retry-After": str(max(1, int(round(e.retry_after_s))))},
                )
            except json.JSONDecodeError:
                self._json(400, {"status": 1, "error": "invalid JSON body"})
            except Exception as e:  # noqa: BLE001 - surface synthesis errors to client
                self._json(500, {"status": 1, "error": str(e)})

    return Handler


def serve(
    cfg: Config,
    synthesizer,
    host: str = "0.0.0.0",
    port: int = 8500,
    max_batch: int = 8,
    max_queue: int = 32,
    max_batch_hard: int | None = None,
):
    service = TTSService(cfg, synthesizer, max_batch=max_batch,
                         max_queue=max_queue, max_batch_hard=max_batch_hard)

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 kernel-resets
        # simultaneous connects under load (measured: 19/128 requests got
        # ECONNRESET at concurrency 64) — admission control belongs to the
        # bounded queue + 503, not the TCP accept queue
        request_queue_size = 128

    httpd = _Server((host, port), make_handler(service))
    # expose the service (warmup + tests read its resolved knobs, e.g.
    # max_batch_hard, instead of re-deriving them)
    httpd.service = service
    _log.info("TTS server on http://%s:%d (POST /generate_tts)", host, port)
    return httpd


def warmup(synth, max_batch_hard: int, text: str = "你好。") -> None:
    """One short request per batch bucket the micro-batcher can form (the
    single path, then every power of two up to the one covering
    ``max_batch_hard``); decode length stays bounded by synth.max_iters."""
    synth.synthesize(text)
    top = 1 << (max_batch_hard - 1).bit_length() if max_batch_hard > 1 else 1
    nb = 2
    while nb <= top:
        synth.synthesize_batch([text] * nb, pad_batch=True)
        nb *= 2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--export-dir", required=True,
                    help="serving artifact directory (tacotron_params.npz, wavernn_params.npz, "
                         "config.json, symbols.txt)")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="max concurrent /generate_tts requests coalesced into one batch")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="admission-control queue bound; requests beyond it get 503 + Retry-After")
    ap.add_argument("--max-batch-hard", type=int, default=None,
                    help="batch ceiling once a backlog forms (default 2x max-batch)")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="decode-length cap in decoder steps (default: config max_iters)")
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from .export import load_exported

    synth = load_exported(args.export_dir, max_iters=args.max_iters, device=args.device)
    httpd = serve(synth.cfg, synth, args.host, args.port, max_batch=args.max_batch,
                  max_queue=args.max_queue, max_batch_hard=args.max_batch_hard)
    if not args.no_warmup:
        _log.info("warming up...")
        warmup(synth, httpd.service.max_batch_hard)
    _log.info("serving")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
