"""Host-side DSP helpers the inference path needs (numpy/scipy/torch)."""

from .mulaw import label_2_float, mu_law_expand
from .spectrogram import mel_to_unit, unit_to_mel
from .wav import postprocess_wav_int16, save_wav

__all__ = [
    "label_2_float",
    "mu_law_expand",
    "mel_to_unit",
    "unit_to_mel",
    "postprocess_wav_int16",
    "save_wav",
]
