"""End-to-end synthesis: text -> pinyin -> mel -> wav.

One padded acoustic decode per batch (the decode kernel on the card), host
trim at each row's stop token, then either one WaveRNN sample-loop call
over all utterances' folds (the RAW kernel, or the plain MOL loop for a
MOL vocoder) or, without a vocoder, a batched Griffin-Lim
reconstruction on the same device (the reference's default path,
tacotron_synthesize.py:110-112).  Inputs are padded to 16-multiple lengths
(and, for serving, power-of-2 batches), and Griffin-Lim mels to 64-frame
buckets, so a few shapes cover all traffic.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Sequence

import numpy as np
import torch

from ..config import Config
from ..dsp import spectrogram as S
from ..dsp import wav as wavio
from ..dsp.griffin_lim import inv_mel_spectrogram
from ..frontend import default_symbols, get_pyin
from ..models import tacotron as T
from ..models import wavernn as W
from ..ops import tacotron_decoder_kernel as DK
from ..utils import resolve_device, round_up
from ..utils.checkpoints import restore_params, tacotron_from_numpy, wavernn_from_numpy
from ..utils.metrics import span
from ..utils.plot import plot_alignment, plot_spectrogram


def _seed_list(seed, n: int) -> list[int]:
    """Normalize a scalar seed or per-example seed sequence to a list[n]."""
    if isinstance(seed, (int, np.integer)):
        return [int(seed)] * n
    seeds = [int(s) for s in seed]
    if len(seeds) != n:
        raise ValueError(f"got {len(seeds)} seeds for {n} examples")
    return seeds


class Synthesizer:
    """Acoustic + vocoder params on one device, and the synthesis calls.

    ``params`` / ``vocoder_params`` are nested dicts of numpy arrays (the
    export artifact's format) or of torch tensors.  ``device=None`` means
    the card, and raises when there is none; pass ``device="cpu"`` for the
    plain path on the CPU.  ``vocoder_params=None`` means Griffin-Lim
    reconstruction, on the same device."""

    def __init__(
        self,
        cfg: Config,
        params: Any,
        vocoder_params: Any | None = None,
        max_iters: int | None = None,
        symbols: Any | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        DK.check_supported(cfg.tacotron, self.device)
        self.params = tacotron_from_numpy(params, cfg.tacotron, self.device)
        self.vocoder_params = None
        if vocoder_params is not None:
            W.check_vocoder_supported(cfg.wavernn, cfg.audio.num_mels)
            self.vocoder_params = wavernn_from_numpy(
                vocoder_params, cfg.wavernn, self.device, cfg.audio.num_mels, cfg.audio.bits
            )
        self.symbols = symbols if symbols is not None else default_symbols()
        self.pipe = S.MelPipeline(cfg.audio, self.device)
        # read at call time, so assigning synth.max_iters later takes effect
        self.max_iters = max_iters or cfg.tacotron.max_iters
        # a RAW vocoder takes each step's argmax instead of sampling; either
        # way it runs through the sample-loop wrapper (the kernel on the card).
        # A MOL vocoder always samples, through the plain MOL loop.
        self.greedy = False

    @classmethod
    def from_checkpoints(cls, cfg: Config, tacotron_ckpt_dir: str, wavernn_ckpt_dir: str | None = None,
                         step: int | None = None, **kw) -> "Synthesizer":
        """Restore params from ``CheckpointManager`` directories (``step``
        picks an acoustic checkpoint, else the latest).  A WaveRNN directory
        that is named but holds no checkpoint raises: it never falls back
        to Griffin-Lim."""
        params = restore_params(tacotron_ckpt_dir, step)
        voc = None if wavernn_ckpt_dir is None else restore_params(wavernn_ckpt_dir)
        return cls(cfg, params, voc, **kw)

    # -- core ---------------------------------------------------------------

    @staticmethod
    def _pad_ids(ids_batch: Sequence[Sequence[int]], pad_batch: bool = False):
        """Pad a token-id batch to a 16-multiple T_in and, with
        ``pad_batch`` (serving), a power-of-2 batch made by duplicating the
        last row."""
        B = len(ids_batch)
        B_pad = (1 << (B - 1).bit_length()) if pad_batch else B
        padded = list(ids_batch) + [ids_batch[-1]] * (B_pad - B)
        lens = [len(x) for x in padded]
        T_in = round_up(max(lens), 16)
        inputs = np.zeros((B_pad, T_in), np.int32)
        for i, ids in enumerate(padded):
            inputs[i, : len(ids)] = ids
        return inputs, lens

    def _decode(self, ids_batch, seed, pad_batch: bool):
        """The padded acoustic decode -> (TacotronOutput on the device, the
        padded rows' input lengths).  Row b's decode noise depends only on
        its own seed."""
        B = len(ids_batch)
        seeds = _seed_list(seed, B)
        inputs, lens = self._pad_ids(ids_batch, pad_batch)
        seeds = seeds + [seeds[-1]] * (inputs.shape[0] - B)
        with span("synth.decode", device=True, rows=B, padded_rows=int(inputs.shape[0]), T_in=int(inputs.shape[1])):
            out = T.forward_inference(
                self.params,
                self.cfg.tacotron,
                torch.as_tensor(inputs, device=self.device),
                torch.as_tensor(np.asarray(lens, np.int64), device=self.device),
                seeds,
                int(self.max_iters),
            )
        return out, lens

    def _trim(self, out, lens, B: int):
        """Per-row host copies trimmed at each stop: (mels [n, 80],
        alignments [ceil(n / r), T_in], stop frame counts n)."""
        with span("synth.trim") as sp:
            stop_len = out.stop_lengths.cpu().numpy()
            mel_all = out.mel_outputs.cpu().numpy()
            align_all = out.alignments.cpu().numpy()
            mels, aligns, stops = [], [], []
            r = self.cfg.tacotron.outputs_per_step
            for i in range(B):
                n = int(stop_len[i])
                mels.append(mel_all[i, :n])
                aligns.append(align_all[i, : -(-n // r), : lens[i]])  # decoder steps: r frames each
                stops.append(n)
            sp.set(frames=sum(stops))
        return mels, aligns, stops

    def mel_from_ids(self, ids_batch, seed: int | Sequence[int] = 0, pad_batch: bool = False):
        """Padded-batch inference -> (mels [T,80], alignments [T,T_in],
        stop frame counts) trimmed per example at the first stop flag."""
        with torch.no_grad():
            out, lens = self._decode(ids_batch, seed, pad_batch)
        return self._trim(out, lens, len(ids_batch))

    def text_to_mel(self, text: str, seed: int = 0):
        """text -> (mel [-4,4], alignment, pyin string)."""
        with span("synth.g2p"):
            pyin, _ = get_pyin(text)
            ids = self.symbols.encode(pyin)
        mels, aligns, _ = self.mel_from_ids([ids], seed=seed)
        return mels[0], aligns[0], pyin

    def mels_to_wavs(self, mels: Sequence[np.ndarray], seed: int = 0) -> list[np.ndarray]:
        """mels [-4,4] -> waveforms: one WaveRNN sample-loop call over all
        utterances' folds, or without a vocoder one batched Griffin-Lim."""
        if self.vocoder_params is None:
            return self.mels_to_wavs_gl(mels)
        units = [S.mel_to_unit(np.asarray(m), self.cfg.audio) for m in mels]
        with torch.no_grad():
            return W.generate_batch(
                self.vocoder_params, self.cfg.wavernn, self.cfg.wavernn_gen, units, seed,
                bits=self.cfg.audio.bits, apply_mu_law=self.cfg.audio.mu_law,
                generate_fn=W.default_generate_fn(self.cfg.wavernn, self.greedy),
            )

    def mel_to_wav(self, mel: np.ndarray, seed: int = 0) -> np.ndarray:
        """mel [-4,4] -> waveform via WaveRNN if loaded, else Griffin-Lim."""
        return self.mels_to_wavs([mel], seed)[0]

    def mels_to_wavs_gl(self, mels: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Batched Griffin-Lim: every mel padded with silence to one 64-frame
        bucket (+1 frame: the reconstruction is hop*(T_pad-1) samples) and
        the batch to a power of two, one reconstruction on the device, each
        wav trimmed to its T*hop.  The phase is shared by all rows, so an
        example equals its ``mel_to_wav`` when both land in the same
        64-frame bucket."""
        T_max = max(m.shape[0] for m in mels)
        T_pad = round_up(max(T_max + 1, 64), 64)
        B = len(mels)
        B_pad = 1 << (B - 1).bit_length()
        stacked = np.full((B_pad, T_pad, mels[0].shape[1]), -self.cfg.audio.max_abs_value, np.float32)
        for i, m in enumerate(mels):
            stacked[i, : m.shape[0]] = m
        with torch.no_grad(), span("synth.griffin_lim", device=True, rows=B, frames=T_pad):
            wavs = inv_mel_spectrogram(stacked, self.pipe)
        hop = self.cfg.audio.hop_size
        return [w[: m.shape[0] * hop] for w, m in zip(wavs, mels)]

    def _gl_from_decode(self, mel: torch.Tensor, stop_lengths: torch.Tensor) -> np.ndarray:
        """The decode's [B, T_max, 80] mels -> [B, samples] host wavs, on the
        device: frames at or past each row's stop become silence, the batch
        is padded with silence to round_up(T_max + 1, 64) frames and
        reconstructed in one Griffin-Lim."""
        silence = -self.cfg.audio.max_abs_value
        t = torch.arange(mel.shape[1], device=mel.device)[None, :, None]
        mel = torch.where(t < stop_lengths[:, None, None], mel, silence)
        T_pad = round_up(mel.shape[1] + 1, 64)
        mel = torch.nn.functional.pad(mel, (0, 0, 0, T_pad - mel.shape[1]), value=silence)
        with span("synth.griffin_lim", device=True, rows=int(mel.shape[0]), frames=T_pad):
            return inv_mel_spectrogram(mel, self.pipe)

    def _synth_gl_batch(self, texts: Sequence[str], seed: int | Sequence[int] = 0, pad_batch: bool = False):
        """text -> wav on the Griffin-Lim path: the decode, then the masked,
        padded, batched reconstruction, without the mel leaving the device
        between them; each row trimmed to its n*hop samples, n mel frames
        and ceil(n / r) alignment steps."""
        pyins, ids = self._encode_texts(texts)
        with torch.no_grad():
            out, lens = self._decode(ids, seed, pad_batch)
            wav_all = self._gl_from_decode(out.mel_outputs, out.stop_lengths)
        mels, aligns, stops = self._trim(out, lens, len(texts))
        hop = self.cfg.audio.hop_size
        return [
            {"wav": wav_all[i, : n * hop], "mel": m, "alignment": a, "pyin": p}
            for i, (n, m, a, p) in enumerate(zip(stops, mels, aligns, pyins))
        ]

    def _encode_texts(self, texts: Sequence[str]):
        pyins, ids = [], []
        with span("synth.g2p", rows=len(texts)):
            for t in texts:
                p, _ = get_pyin(t)
                pyins.append(p)
                ids.append(self.symbols.encode(p))
        return pyins, ids

    def synthesize(self, text: str, out_dir: str | None = None, seed: int = 0):
        """Full pipeline; optionally writes the wav, the [0,1] mel .npy and
        mel/alignment PNGs keyed by md5(text)."""
        if self.vocoder_params is None:
            result = self._synth_gl_batch([text], seed=seed)[0]
        else:
            mel, align, pyin = self.text_to_mel(text, seed=seed)
            result = {"wav": self.mel_to_wav(mel, seed=seed), "mel": mel, "alignment": align, "pyin": pyin}
        wav, mel, align = result["wav"], result["mel"], result["alignment"]
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            name = hashlib.md5(text.encode("utf-8")).hexdigest()[:16]
            paths = {
                "wav": os.path.join(out_dir, f"wav-{name}.wav"),
                "mel": os.path.join(out_dir, f"mel-{name}.npy"),
            }
            wavio.save_wav(wav, paths["wav"], self.cfg.audio.sample_rate)
            np.save(paths["mel"], S.mel_to_unit(np.asarray(mel), self.cfg.audio).astype(np.float32))
            plot_alignment(align, os.path.join(out_dir, f"align-{name}.png"), title=text)
            plot_spectrogram(mel, os.path.join(out_dir, f"mel-{name}.png"))
            result["paths"] = paths
        return result

    def synthesize_batch(self, texts: Sequence[str], seed: int | Sequence[int] = 0, pad_batch: bool = False):
        """One padded acoustic decode for all texts, then one vocoder call
        over all utterances' folds, or one batched Griffin-Lim.  The
        vocoder's sampling noise uses the first seed over the concatenated
        fold batch."""
        if self.vocoder_params is None:
            return self._synth_gl_batch(texts, seed=seed, pad_batch=pad_batch)
        pyins, ids = self._encode_texts(texts)
        seeds = _seed_list(seed, len(texts))
        mels, aligns, _ = self.mel_from_ids(ids, seed=seeds, pad_batch=pad_batch)
        wavs = self.mels_to_wavs(mels, seed=seeds[0])
        return [
            {"wav": w, "mel": m, "alignment": a, "pyin": p}
            for w, m, a, p in zip(wavs, mels, aligns, pyins)
        ]

    def run_live(self):  # pragma: no cover - interactive
        """stdin REPL (reference synthesize.py run_live)."""
        import sys

        print("> ", end="", flush=True)
        for line in sys.stdin:
            text = line.strip()
            if not text:
                continue
            r = self.synthesize(text, out_dir="tacotron_inference_output")
            print(f"wrote {r['paths']['wav']}\n> ", end="", flush=True)

