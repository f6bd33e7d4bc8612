"""What decides ``correct`` in a serving cell: every answer's form, and a
sample of the served requests, drawn from the seed with the longest text
in it, against the plain reference.

Numbers compared, each against the limit the traffic mix states:

* ``wrong_answers``: requests that got no answer, or a 200 whose status,
  WAV or length is not the configured one (every request of the window);
* ``g2p_mismatch``: answered requests whose phoneme string (the G2P and
  the text normalisation) is not the reference frontend's for their text
  (every answered request of the window);
* ``decoder_gap``: the reference decoder, fed the served frames (frame
  t - 1 into step t, the prenet's dropout drawn from the request's seed),
  against each served frame, max |d| over the sample;
* ``postnet_gap``: the reference postnet over the served frames against
  the served mel, max |d|;
* ``vocoder_gap`` (WaveRNN): teacher-forced on the served labels, how far
  a served label's perturbed logit lies below the best one, widest over
  every sampled step (the Gumbel noise drawn from the call's seed);
* ``crossfade_gap`` (WaveRNN): the reference's crossfade of the served
  labels against the served waveform, max |d|;
* ``griffin_lim_gap`` (Griffin-Lim): the reference reconstruction of the
  served mels, as the batch they were served in, against the served
  waveform, max |d| over max |wav|;
* ``pcm_gap``: the reference WAV chain over the served waveform against
  the response's int16 samples, max |d|.

The control (``control=True``) puts the reference computed with TF32 in
the program's place: each number reads the TF32 reference's output against
the float32 reference's at the same positions (for the vocoder, the gap of
the label TF32 ranks first).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..reference import audio as RA
from ..reference import frontend as RF
from ..reference import precision
from ..reference import tacotron as RT
from ..reference import wavernn as RW

SYMBOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference", "symbols.txt")


def symbol_ids(pyin: str) -> list:
    """A phoneme string -> ids (unknown tokens dropped) and the EOS id."""
    with open(SYMBOLS, encoding="utf-8") as f:
        table = {s: i for i, s in enumerate(line.rstrip("\n") for line in f if line.rstrip("\n"))}
    return [table[t] for t in pyin.split(" ") if t in table] + [table["~"]]


def wrong_answers(results: list, samples: int) -> int:
    """No answer at all, or a 200 that is not a WAV of ``samples`` samples
    at status 0.  A 503 is a refusal, counted as failed, not wrong."""
    bad = 0
    for r in results:
        if r["code"] in (-1, -2):
            bad += 1
        elif r["code"] == 200 and (r.get("status") != 0 or r.get("samples") != samples or not r.get("pyin")):
            bad += 1
    return bad


def _max(x) -> float:
    return float(torch.as_tensor(x).abs().max()) if torch.as_tensor(x).numel() else 0.0


def _decoder(tp, tc, ids, T_in, frames_in, seed, dev, tf32):
    L = len(ids)
    padded = torch.zeros(T_in, dtype=torch.int64, device=dev)
    padded[:L] = torch.as_tensor(ids, device=dev)
    with precision(tf32), torch.no_grad():
        mem = RT.encode(tp, tc, padded, L)
        fr, _, _ = RT.decode_teacher_forced(tp, tc, mem, L, frames_in, seed)
        mel = RT.postnet(tp, tc, RT.clip_mel(frames_in, tc))
    return fr, mel


def g2p_mismatch(results: list, texts: dict) -> int:
    """Answered requests whose served phonemes are not the reference's."""
    return sum(1 for r in results
               if r["code"] == 200 and r.get("pyin") and r["pyin"] != RF.phonemes(texts[r["seed"]]))


def readings(conf: dict, tp, vp, capture, results: list, samples: int, dev, texts: dict, control: bool = False,
             compare: int = 4, chunk: int = 2048) -> dict:
    """Every number compared, for the program's served outputs (or, with
    ``control``, for the TF32 reference in their place).  ``texts``: each
    request's text by its seed."""
    tc, hop = conf["tacotron"], conf["audio"]["hop_size"]
    out = {"wrong_answers": wrong_answers(results, samples),
           "g2p_mismatch": 0 if control else g2p_mismatch(results, texts)}
    by_seed = {r["seed"]: r for r in results}
    gaps = {"decoder_gap": 0.0, "postnet_gap": 0.0, "pcm_gap": 0.0}
    if vp is not None:
        gaps.update(vocoder_gap=0.0, crossfade_gap=0.0)
    else:
        gaps.update(griffin_lim_gap=0.0)
    checked = 0
    for seed in capture.keep_order:
        if checked >= compare:
            break
        r = by_seed.get(seed)
        served = capture.results.get(seed)
        dec = capture.decodes.get(seed)
        if r is None or served is None or dec is None or r.get("code") != 200:
            continue
        checked += 1
        if r.get("pyin") != served["pyin"]:
            out["wrong_answers"] += 1
        ids = symbol_ids(served["pyin"])
        frames_in = dec["frames"].to(dev)
        fr32, mel32 = _decoder(tp, tc, ids, dec["T_in"], frames_in, seed, dev, False)
        if control:
            fr_s, mel_s = _decoder(tp, tc, ids, dec["T_in"], frames_in, seed, dev, True)
        else:
            fr_s, mel_s = frames_in, torch.as_tensor(served["mel"], device=dev)
        gaps["decoder_gap"] = max(gaps["decoder_gap"], _max(fr32 - fr_s))
        gaps["postnet_gap"] = max(gaps["postnet_gap"], _max(mel32[: mel_s.shape[0]] - mel_s))
        wav = np.asarray(served["wav"], np.float32)
        if vp is not None:
            g, x = vocoder_gaps(conf, vp, capture, seed, served, dev, control, chunk)
            gaps["vocoder_gap"] = max(gaps["vocoder_gap"], g)
            gaps["crossfade_gap"] = max(gaps["crossfade_gap"], x)
        else:
            gaps["griffin_lim_gap"] = max(gaps["griffin_lim_gap"],
                                          griffin_lim_gap(conf, capture, seed, served, dev, control, samples // hop))
        if r.get("wav_b64") and not control:
            pcm = RA.wav_pcm(r["wav_b64"]).astype(np.int32)
            ref = RA.postprocess_int16(wav).astype(np.int32)
            gaps["pcm_gap"] = max(gaps["pcm_gap"], float(np.abs(pcm - ref).max()) if pcm.shape == ref.shape
                                  else math.inf)
    out.update(gaps)
    out["requests_compared"] = checked
    return out


def vocoder_gaps(conf, vp, capture, seed, served, dev, control, chunk):
    """(widest gap below the best perturbed logit, crossfade max |d|) of
    one served request."""
    wc, gen, ac = conf["wavernn"], conf["wavernn_gen"], conf["audio"]
    bits, hop = ac["bits"], ac["hop_size"]
    call = capture.call_of(seed, "k1")
    k1 = call["k1"]
    folds_per_row = [RW.fold(np.zeros((n, 1), np.float32), gen["target"] // hop, gen["overlap"] // hop).shape[0]
                     for n in call["frames_rows"]]
    row = call["seeds"].index(seed)
    fold0 = sum(folds_per_row[:row])
    n = folds_per_row[row]
    labels = k1["labels"][:, fold0: fold0 + n].t().contiguous().to(dev)
    folds = torch.as_tensor(RW.fold_mels(served["mel"], wc, gen, ac["max_abs_value"]), device=dev)
    T = labels.shape[1]
    widest = 0.0
    with torch.no_grad():
        with precision(False):
            hid32 = RW.hidden(vp, wc, folds, labels, bits)
        if control:
            with precision(True):
                hid_c = RW.hidden(vp, wc, folds, labels, bits)
        for s in range(0, T, chunk):
            e = min(T, s + chunk)
            with precision(False):
                z32 = RW.perturbed_logits(vp, hid32, s, e, k1["seed"], fold0, bits, not k1["greedy"])
            if control:
                with precision(True):
                    zc = RW.perturbed_logits(vp, hid_c, s, e, k1["seed"], fold0, bits, not k1["greedy"])
                chosen = zc.argmax(dim=-1)
                del zc
            else:
                chosen = labels[:, s:e]
            widest = max(widest, float(RW.gap_below_best(z32, chosen).max()))
            del z32
    if control:
        return widest, 0.0
    y = (RW.mu_law_expand(labels, bits) if ac["mu_law"] else RW.label_to_float(labels, bits)).cpu().numpy()
    wav_ref = RW.fade_out(RW.crossfade(y, gen["overlap"])[: len(served["wav"])], hop)
    return widest, float(np.abs(wav_ref - np.asarray(served["wav"], np.float32)).max())


def griffin_lim_gap(conf, capture, seed, served, dev, control, decode_frames: int) -> float:
    """The served waveform against the reference's reconstruction of the
    batch it was served in, max |d| over max |wav|."""
    from ..reference import griffin_lim as RG

    ac = conf["audio"]
    call = capture.call_of(seed, "mels_rows")
    row = call["seeds"].index(seed)
    mels = [np.asarray(m, np.float32) for m in call["mels_rows"]]
    with torch.no_grad():
        with precision(False):
            ref = RG.reconstruct(mels, ac, dev, decode_frames, call["batch_rows"])[row]
        if control:
            with precision(True):
                got = RG.reconstruct(mels, ac, dev, decode_frames, call["batch_rows"])[row]
        else:
            got = np.asarray(served["wav"], np.float32)
    if len(ref) != len(got):
        return math.inf
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-9))


def judge(limits: dict, values: dict) -> dict:
    """Each number beside its limit."""
    from ..core import check

    return {k: check(values[k], limits[k]) for k in limits if k in values}
