"""DSP: the STFT/mel pipeline and Griffin-Lim on torch tensors, mu-law
labels, and host-side wav I/O and conditioning (numpy/scipy)."""

from .griffin_lim import (
    griffin_lim,
    inv_linear_spectrogram,
    inv_mel_spectrogram,
    inv_preemphasis_scan,
    preemphasis_fir,
)
from .mulaw import decode_mu_law, encode_mu_law, float_2_label, label_2_float, mu_law_expand
from .spectrogram import (
    MelPipeline,
    amp_to_db,
    db_to_amp,
    denormalize,
    istft,
    mel_basis,
    mel_to_unit,
    normalize,
    num_frames,
    stft,
    unit_to_mel,
)
from .wav import (
    dc_notch_filter,
    inv_preemphasis,
    load_wav,
    postprocess_wav_int16,
    preemphasis,
    rescale,
    save_wav,
    trim_silence,
)

__all__ = [
    "MelPipeline",
    "stft",
    "istft",
    "mel_basis",
    "num_frames",
    "amp_to_db",
    "db_to_amp",
    "normalize",
    "denormalize",
    "mel_to_unit",
    "unit_to_mel",
    "griffin_lim",
    "inv_mel_spectrogram",
    "inv_linear_spectrogram",
    "inv_preemphasis_scan",
    "preemphasis_fir",
    "encode_mu_law",
    "decode_mu_law",
    "label_2_float",
    "float_2_label",
    "mu_law_expand",
    "load_wav",
    "save_wav",
    "postprocess_wav_int16",
    "preemphasis",
    "inv_preemphasis",
    "trim_silence",
    "rescale",
    "dc_notch_filter",
]
