"""The open-loop client: sends each request of a schedule at its due time,
whatever the server is doing, from a process of its own (so that it does
not share the server's interpreter lock).

    python3 benchmark/client.py <schedule.json> <results.json>

The schedule holds the port, the monotonic time of the window's start and
the requests (due offset, text, seed, and whether to keep the response's
audio).  Each request is timed from its due time to the last byte of its
response; the client records how late it sent each one.  Standard library
only.
"""

from __future__ import annotations

import base64
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import wave


def wav_samples(b64: str):
    """(sample count, sample rate) of a base64 WAV."""
    with wave.open(io.BytesIO(base64.b64decode(b64))) as wf:
        return wf.getnframes(), wf.getframerate()


def send(url: str, req: dict, t0: float, timeout: float, out: dict) -> None:
    due = t0 + req["due"]
    rec = {"i": req["i"], "seed": req["seed"], "due": due}
    rec["sent"] = time.monotonic()
    body = json.dumps({"text": req["text"], "seed": req["seed"]}).encode("utf-8")
    r = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            data, code = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        data, code = e.read(), e.code
    except Exception as e:  # noqa: BLE001 - no answer: recorded as such
        data, code, rec["error"] = b"", -1, repr(e)
    rec["done"] = time.monotonic()
    rec["code"] = code
    try:
        payload = json.loads(data) if data else {}
    except ValueError:
        payload = {}
    rec["status"] = payload.get("status")
    rec["pyin"] = payload.get("pyin")
    if code == 200 and payload.get("status") == 0:
        try:
            n, sr = wav_samples(payload["wav_b64"])
            rec["samples"], rec["sample_rate"] = n, sr
            rec["audio_s"] = n / sr
        except Exception as e:  # noqa: BLE001 - a malformed WAV is a wrong answer
            rec["wav_error"] = repr(e)
        if req.get("keep"):
            rec["wav_b64"] = payload.get("wav_b64")
    out[req["i"]] = rec


def main(argv) -> int:
    with open(argv[1], encoding="utf-8") as f:
        sched = json.load(f)
    url = f"http://127.0.0.1:{sched['port']}/generate_tts"
    t0, timeout = sched["t0"], sched["timeout_s"]
    out: dict = {}
    threads, late = [], 0.0
    for req in sorted(sched["requests"], key=lambda r: r["due"]):
        wait = t0 + req["due"] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.monotonic() - (t0 + req["due"]))
        th = threading.Thread(target=send, args=(url, req, t0, timeout, out), daemon=True)
        th.start()
        threads.append(th)
    deadline = t0 + sched["window_s"] + timeout
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    results = [out.get(r["i"], {"i": r["i"], "seed": r["seed"], "due": t0 + r["due"], "code": -2,
                                "error": "no answer before the deadline"})
               for r in sched["requests"]]
    with open(argv[2], "w", encoding="utf-8") as f:
        json.dump({"results": results, "max_late_s": late}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
