"""End-to-end synthesis: text -> pinyin -> mel -> wav (WaveRNN vocoder).

One padded acoustic decode per batch (the decode kernel on the card), host
trim at each row's stop token, then one sample-loop call over all
utterances' folds.  Inputs are padded to 16-multiple lengths (and, for
serving, power-of-2 batches) so a few shapes cover all traffic.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Any, Sequence

import numpy as np
import torch

from ..config import Config
from ..dsp import spectrogram as S
from ..dsp import wav as wavio
from ..frontend import default_symbols, get_pyin
from ..models import tacotron as T
from ..models import wavernn as W
from ..ops import tacotron_decoder_kernel as DK
from ..ops import wavernn_kernel as WK
from ..utils import resolve_device, round_up
from ..utils.checkpoints import tacotron_from_numpy, wavernn_from_numpy
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
    plain path on the CPU.  Without a vocoder (the Griffin-Lim path) the
    synthesis calls raise: that path is not ported yet."""

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
            WK.check_supported(cfg.wavernn, cfg.audio.num_mels)
            self.vocoder_params = wavernn_from_numpy(
                vocoder_params, cfg.wavernn, self.device, cfg.audio.num_mels, cfg.audio.bits
            )
        self.symbols = symbols if symbols is not None else default_symbols()
        # read at call time, so assigning synth.max_iters later takes effect
        self.max_iters = max_iters or cfg.tacotron.max_iters
        # the vocoder takes each step's argmax instead of sampling; either
        # way it runs through the sample-loop wrapper (the kernel on the card)
        self.greedy = False

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

    def mel_from_ids(self, ids_batch, seed: int | Sequence[int] = 0, pad_batch: bool = False):
        """Padded-batch inference -> (mels [T,80], alignments [T,T_in],
        stop frame counts) trimmed per example at the first stop flag.
        Row b's decode noise depends only on its own seed."""
        B = len(ids_batch)
        seeds = _seed_list(seed, B)
        inputs, lens = self._pad_ids(ids_batch, pad_batch)
        seeds = seeds + [seeds[-1]] * (inputs.shape[0] - B)
        with torch.no_grad():
            out = T.forward_inference(
                self.params,
                self.cfg.tacotron,
                torch.as_tensor(inputs, device=self.device),
                torch.as_tensor(np.asarray(lens, np.int64), device=self.device),
                seeds,
                int(self.max_iters),
            )
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
        return mels, aligns, stops

    def text_to_mel(self, text: str, seed: int = 0):
        """text -> (mel [-4,4], alignment, pyin string)."""
        pyin, _ = get_pyin(text)
        mels, aligns, _ = self.mel_from_ids([self.symbols.encode(pyin)], seed=seed)
        return mels[0], aligns[0], pyin

    def _require_vocoder(self) -> None:
        if self.vocoder_params is None:
            raise NotImplementedError(
                "Griffin-Lim vocoding is not ported yet (ROADMAP.md, queue item 7); "
                "load WaveRNN weights"
            )

    def mels_to_wavs(self, mels: Sequence[np.ndarray], seed: int = 0) -> list[np.ndarray]:
        """mels [-4,4] -> waveforms through one WaveRNN sample-loop call
        over all utterances' folds."""
        self._require_vocoder()
        units = [S.mel_to_unit(np.asarray(m), self.cfg.audio) for m in mels]
        with torch.no_grad():
            return W.generate_batch(
                self.vocoder_params, self.cfg.wavernn, self.cfg.wavernn_gen, units, seed,
                bits=self.cfg.audio.bits, apply_mu_law=self.cfg.audio.mu_law,
                generate_fn=functools.partial(W.generate_kernel, greedy=self.greedy),
            )

    def mel_to_wav(self, mel: np.ndarray, seed: int = 0) -> np.ndarray:
        return self.mels_to_wavs([mel], seed)[0]

    def synthesize(self, text: str, out_dir: str | None = None, seed: int = 0):
        """Full pipeline; optionally writes the wav, the [0,1] mel .npy and
        mel/alignment PNGs keyed by md5(text)."""
        self._require_vocoder()
        mel, align, pyin = self.text_to_mel(text, seed=seed)
        wav = self.mel_to_wav(mel, seed=seed)
        result = {"wav": wav, "mel": mel, "alignment": align, "pyin": pyin}
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
        over all utterances' folds.  The vocoder's sampling noise uses the
        first seed over the concatenated fold batch."""
        self._require_vocoder()
        pyins, ids = [], []
        for t in texts:
            p, _ = get_pyin(t)
            pyins.append(p)
            ids.append(self.symbols.encode(p))
        seeds = _seed_list(seed, len(texts))
        mels, aligns, _ = self.mel_from_ids(ids, seed=seeds, pad_batch=pad_batch)
        wavs = self.mels_to_wavs(mels, seed=seeds[0])
        return [
            {"wav": w, "mel": m, "alignment": a, "pyin": p}
            for w, m, a, p in zip(wavs, mels, aligns, pyins)
        ]
