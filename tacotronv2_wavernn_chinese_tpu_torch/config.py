"""Single configuration tree for the whole framework.

Replaces the reference's three overlapping config systems (tf.contrib HParams
at tacotron_hparams.py:5-239, module globals at wavernn_hparams.py:1-58, and
the import-a-python-file loader at wavernn/utils/__init__.py:40-104) with one
dataclass tree plus dotted-path CLI overrides.  Every flag here is real: modes
the reference force-overrides in code (``gta`` at tacotron.py:33, ``batched``
at wavernn_gen.py:77) are honest knobs in this framework.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Audio/DSP constants (reference tacotron_hparams.py:82-189)."""

    sample_rate: int = 22050
    n_fft: int = 2048
    hop_size: int = 275
    win_size: int = 1100
    num_mels: int = 80
    num_freq: int = 1025  # n_fft // 2 + 1
    fmin: float = 95.0
    fmax: float = 7600.0
    preemphasis: float = 0.97
    preemphasize: bool = True
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    # Symmetric [-4, 4] mel normalization (the acoustic-model convention).
    max_abs_value: float = 4.0
    symmetric_mels: bool = True
    allow_clipping_in_normalization: bool = True
    # wav conditioning
    rescale: bool = True
    rescaling_max: float = 0.999
    trim_silence: bool = True
    trim_top_db: float = 25.0
    trim_fft_size: int = 2048
    trim_hop_size: int = 512
    # Griffin-Lim
    power: float = 1.5
    griffin_lim_iters: int = 60
    # mu-law / vocoder bit depth
    bits: int = 10
    mu_law: bool = True
    peak_norm: bool = True
    # magnitude floor before log (librosa amp_to_db parity)
    magnitude_power: float = 2.0

    @property
    def mu_classes(self) -> int:
        return 2 ** self.bits


@dataclass(frozen=True)
class TacotronModelConfig:
    """Acoustic model architecture (reference tacotron_hparams.py:100-160)."""

    vocab_size: int = 191  # frozen symbol table; see frontend/data/symbols.txt
    embedding_dim: int = 128
    # encoder
    enc_conv_layers: int = 3
    enc_conv_kernel: int = 5
    enc_conv_channels: int = 256
    encoder_lstm_units: int = 256  # per direction
    # attention
    attention_mode: str = "forward"  # forward|lsa|gmm|graves
    attention_dim: int = 128
    attention_filters: int = 32
    attention_kernel: int = 31
    num_attn_mixtures: int = 5  # GMM mode (reference tacotron_gmm.py:81)
    graves_heads: int = 10
    cumulative_weights: bool = True
    smoothing: bool = False
    # inference-time attention constraints (reference forward_attention.py:171-215,
    # location_sensitive_attention.py:201-214)
    synthesis_constraint: bool = False
    synthesis_window: int = 3
    anti_repeat: bool = False
    dwell_limit_first: int = 5
    dwell_limit_rest: int = 10
    # decoder
    prenet_layers: Tuple[int, ...] = (256, 256)
    decoder_layers: int = 2
    decoder_lstm_units: int = 256
    outputs_per_step: int = 1  # r
    max_iters: int = 2000
    stop_at_any: bool = True
    # postnet
    postnet_layers: int = 5
    postnet_kernel: int = 5
    postnet_channels: int = 256
    # optional CBHG mel->linear head (reference modules.py:4-78)
    predict_linear: bool = False
    cbhg_kernels: int = 8
    cbhg_conv_channels: int = 128
    cbhg_pool_size: int = 2
    cbhg_projection: int = 256
    cbhg_highway_units: int = 128
    cbhg_highwaynet_layers: int = 4
    cbhg_rnn_units: int = 128
    # regularization
    zoneout_rate: float = 0.1
    dropout_rate: float = 0.5
    # clipping of mel outputs (reference tacotron.py:111-112)
    clip_outputs: bool = True
    lower_bound_decay: float = 0.1
    # fused-decoder-kernel precision for VMEM-resident attention keys/values:
    # "bf16" (default; T_in envelope ~768) or "f32" (exact energies, ~384).
    # dtype=f32 parity tests always keep kv f32.
    kernel_kv_dtype: str = "bf16"
    # fused-decoder-kernel precision for the VMEM-resident WEIGHTS: "bf16"
    # (default — the perf configuration) or "f32" (debug/parity: removes the
    # kernel's only quantization vs the XLA decode at the cost of ~half the
    # T_in envelope; with f32 weights the kv precision follows suit, and
    # on-chip decode trajectories converge to the XLA path's —
    # tools/check_kernel_parity_tpu.py --weights-dtype f32).
    kernel_weights_dtype: str = "bf16"


@dataclass(frozen=True)
class TacotronTrainConfig:
    """Acoustic training (reference tacotron_hparams.py:190-239)."""

    batch_size: int = 32
    reg_weight: float = 1e-6
    scale_regularization: bool = False
    train_steps: int = 300000
    # lr schedule: exponential decay from decay_start over decay_steps, x decay_rate
    initial_lr: float = 1e-3
    final_lr: float = 1e-5
    decay_start: int = 66000
    decay_steps: int = 20000
    decay_rate: float = 0.5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-6
    grad_clip_norm: float = 1.0
    # teacher forcing: constant ratio, or cosine-decayed scheduled sampling
    # (reference helpers.py:153-186 _teacher_forcing_ratio_decay)
    teacher_forcing_mode: str = "constant"  # constant | scheduled
    teacher_forcing_ratio: float = 1.0
    teacher_forcing_init_ratio: float = 1.0
    # final ratio and decay alpha are ONE knob, reference-style: the cosine
    # floor is final/init when final_ratio is set, else decay_alpha
    # (tf.train.cosine_decay alpha; reference hparams 227-233: final 0.3,
    # start 70k, steps 150k, alpha None)
    teacher_forcing_final_ratio: float | None = 0.3
    teacher_forcing_start_decay: int = 70000
    teacher_forcing_decay_steps: int = 150000
    teacher_forcing_decay_alpha: float | None = None
    mask_decoder: bool = False
    stop_pos_weight: float = 20.0  # cross_entropy_pos_weight
    # bf16 weights / f32 master+activations (utils/precision.py) — halves the
    # decoder scan's per-step weight HBM reads; the reference is f32-only
    mixed_precision: bool = False
    # lax.scan unroll factor for the teacher-forced decoder scan: >1 trades
    # compile time/code size for fewer per-iteration loop overheads on the
    # recurrence-bound step (measured on v5e B=32: 72.1 -> 58.6 ms/step at
    # unroll=2, 58.1 at 4; numerically identical outputs)
    scan_unroll: int = 2
    # fused Pallas training decoder (ops/tacotron_trainer_kernel.py — custom
    # VJP over the teacher-forced scan): "auto" (default) uses it on TPU
    # whenever the config/shape qualify (forward attention, ratio 1.0,
    # T_in <= 256) AND batch <= fused_auto_max_batch; "on" forces it
    # (interpret-mode on CPU is test-only); "off" disables.
    fused_decoder: str = "auto"
    # measured crossover (v5e, T_out=512, marginal whole-step): B=8 fused
    # 12.1 ms vs scan 18.2 (1.50x); B=16 22.7 vs 23.0; B=32 the scan wins
    # 31.7 vs 43.6 (sequential 8-row Mosaic groups).  See BASELINE.md.
    fused_auto_max_batch: int = 16
    # weight-gradient layout of the fused backward: "accum" keeps them in
    # VMEM via per-chunk MXU reductions (no [T, B, 4u] adjoint streams, no
    # scoped-vmem compiler flag); "stream" is the round-3 layout
    fused_wgrads: str = "accum"
    fine_tune: bool = False  # freeze embedding+encoder (reference tacotron.py:167-169)
    checkpoint_interval: int = 500
    summary_interval: int = 1000
    eval_sentences: int = 1
    max_mel_frames: int = 900
    clip_mels_length: bool = False
    data_seed: int = 1234
    # pre-compile every bucketed batch shape before the first real step
    # (replays the shuffle+bucket logic over the planned epochs from
    # metadata lengths alone): steady-state training then never pays a
    # mid-run XLA compile — the round-3 endurance run measured p95 2.32 s
    # vs p50 0.156 s purely from bucket-shape compile churn
    precompile_buckets: bool = True
    # pad-shape rounding multiples: larger values -> fewer compiled shapes
    # but more padded (loss-masked, compute-wasting) frames/tokens.  With
    # precompile_buckets the compile count is paid up front, so tightening
    # these trades a longer one-time prewarm for less per-step padding
    # waste forever.  Measured on the 10k-utterance corpus
    # (loader.padding_stats, ENDURANCE_r5): mel multiple 64 = 16 shapes /
    # 12.7% padded mel frames (8.6% from the multiples); 32 = 26 shapes /
    # 8.6% (4.3%); 16 = 45 shapes / 6.6% (2.2%).  Default 32: the decoder
    # scan is frame-proportional, so this buys ~4.5% whole-run training
    # throughput for ~10 extra cached compiles.
    input_pad_multiple: int = 16
    mel_pad_multiple: int = 32
    shuffle_seed: int = 5339
    batches_per_group: int = 20
    max_checkpoints_to_keep: int = 20
    loss_explosion_threshold: float = 100.0


@dataclass(frozen=True)
class WaveRNNModelConfig:
    """Vocoder architecture (reference wavernn_hparams.py:27-43)."""

    mode: str = "RAW"  # RAW (softmax over 2**bits) | MOL
    upsample_factors: Tuple[int, ...] = (5, 5, 11)
    rnn_dims: int = 512
    fc_dims: int = 512
    compute_dims: int = 128
    res_out_dims: int = 128
    res_blocks: int = 10
    pad: int = 2  # mel context frames each side

    @property
    def total_upsample(self) -> int:
        out = 1
        for f in self.upsample_factors:
            out *= f
        return out


@dataclass(frozen=True)
class WaveRNNTrainConfig:
    """Vocoder training (reference wavernn_hparams.py:44-52)."""

    batch_size: int = 32
    lr: float = 1e-4
    total_steps: int = 500000
    checkpoint_every: int = 1000
    summary_interval: int = 100  # scalars.jsonl cadence (matches tacotron's knob)
    gen_at_checkpoint: int = 5
    test_samples: int = 50
    seq_len_hops: int = 5  # seq_len = hop_size * 5 = 1375
    grad_clip_norm: float = 4.0
    seed: int = 1234
    max_checkpoints_to_keep: int = 20
    # bf16 weights / f32 master+activations (utils/precision.py)
    mixed_precision: bool = False
    # compile the (fixed-window) train-step programs before the first real
    # step, like tacotron_train.precompile_buckets — kills the multi-second
    # first-dispatch tail in step-time percentiles (RESUME_r4: p95 5.87 s vs
    # p50 0.43 s came from exactly this)
    precompile: bool = True


@dataclass(frozen=True)
class WaveRNNGenConfig:
    """Batched-fold generation (reference wavernn_hparams.py:53-58)."""

    batched: bool = True
    # samples per fold (reference default, wavernn_hparams.py:55-57).  Folds
    # generate in parallel on the batch axis, so per-utterance LATENCY scales
    # with fold length — the small reference value is the right default for
    # the interactive paths (synthesizer, serving, CLI).  For bulk THROUGHPUT
    # on long utterances, longer folds amortize the 550-sample crossfade
    # overlap recompute (10% at 11000 vs 3.2% at 33000); a v5e fold-length
    # sweep measured 596x (11000) -> 666x (33000) realtime on the fused
    # kernel, and bench.py uses 33000 explicitly for that reason.
    target: int = 11000
    overlap: int = 550  # crossfade overlap
    # Kept so config.json artifacts written by the JAX package load
    # unchanged.  The port ignores it: on the card the sample loop always
    # runs the CUDA kernel (ops/wavernn_kernel.py), there is no other path.
    use_pallas: bool = True


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN V1 (Kong et al. 2020, §2 and App. A; widths as
    jik876/hifi-gan ``config_v1.json``): the generator, the multi-period
    and the multi-scale discriminators (``models/hifigan.py``), and the
    mel both the input and the loss are computed with
    (``dsp.spectrogram.hifigan_mel``).  The generator is V1's (ResBlock1);
    the discriminators' widths are fields so that tests can shrink them,
    the published ones the defaults, and their periods, kernels, strides
    and groups ``models.hifigan``'s constants."""

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    num_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    fmax_for_loss: float | None = None  # None: sample_rate / 2
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    mpd_channels: Tuple[int, ...] = (32, 128, 512, 1024, 1024)
    msd_channels: Tuple[int, ...] = (128, 128, 256, 512, 1024, 1024, 1024)


@dataclass(frozen=True)
class HiFiGANTrainConfig:
    """HiFi-GAN training (jik876/hifi-gan ``config_v1.json`` and
    ``train.py``): AdamW on each network with decoupled decay (torch's
    default 0.01, which ``train.py`` keeps), the learning rate times
    ``lr_decay`` each epoch, no clipping, the mel loss x 45 and
    ``feature_loss``'s factor of 2."""

    batch_size: int = 16
    segment_size: int = 8192
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    lr_decay: float = 0.999
    mel_loss_weight: float = 45.0
    fm_loss_weight: float = 2.0
    total_steps: int = 2500000
    checkpoint_every: int = 5000
    summary_interval: int = 100
    seed: int = 1234
    max_checkpoints_to_keep: int = 20


@dataclass(frozen=True)
class DataConfig:
    dataset_root: str = "./dataset/BZNSYP"
    out_dir: str = "./training_data"
    metadata_file: str = "train.txt"
    wavernn_metadata_file: str = "wavernn_training_data.txt"
    n_jobs: int = 0  # 0 -> 2 * cpu_count
    test_size: float = 0.05  # held-out fraction for eval batches


@dataclass(frozen=True)
class MeshConfig:
    """GSPMD mesh layout; DP-dominant (models fit on one chip)."""

    data_axis: str = "data"
    # fold axis used by sequence-parallel batched vocoder generation
    fold_axis: str = "data"


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    tacotron: TacotronModelConfig = field(default_factory=TacotronModelConfig)
    tacotron_train: TacotronTrainConfig = field(default_factory=TacotronTrainConfig)
    wavernn: WaveRNNModelConfig = field(default_factory=WaveRNNModelConfig)
    wavernn_train: WaveRNNTrainConfig = field(default_factory=WaveRNNTrainConfig)
    wavernn_gen: WaveRNNGenConfig = field(default_factory=WaveRNNGenConfig)
    hifigan: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    hifigan_train: HiFiGANTrainConfig = field(default_factory=HiFiGANTrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # -- overrides ---------------------------------------------------------
    def override(self, assignments: str | dict[str, Any]) -> "Config":
        """Return a new Config with ``a.b=v`` comma-separated overrides applied.

        Replaces the reference's ``hparams.parse()`` string override path
        (tacotron_train.py:40).
        """
        if isinstance(assignments, str):
            pairs = {}
            for item in filter(None, (s.strip() for s in _split_assignments(assignments))):
                key, _, val = item.partition("=")
                pairs[key.strip()] = val.strip()
        else:
            pairs = dict(assignments)
        cfg = self
        for key, val in pairs.items():
            cfg = _set_dotted(cfg, key, val)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def debug_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True, default=str)


def _split_assignments(text: str) -> list[str]:
    """Split ``a=1,b=(2,3),c=4`` on commas OUTSIDE parens/brackets so
    tuple-valued overrides work (plain str.split broke them)."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _coerce(old: Any, val: Any) -> Any:
    if not isinstance(val, str):
        return val
    if isinstance(old, bool):
        return val.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int):
        return int(val)
    if isinstance(old, float):
        return float(val)
    if isinstance(old, tuple):
        parts = [p for p in val.strip("()[] ").split(",") if p.strip()]
        elem = old[0] if old else 1
        return tuple(type(elem)(p.strip()) for p in parts)
    return val


def _set_dotted(cfg: Any, dotted: str, val: Any) -> Any:
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"unknown config field {dotted!r}")
    cur = getattr(cfg, head)
    if rest:
        new = _set_dotted(cur, rest, val)
    else:
        new = _coerce(cur, val)
    return dataclasses.replace(cfg, **{head: new})


def default_config() -> Config:
    return Config()


def _config_from_dict(d: dict) -> Config:
    """Rebuild the frozen dataclass tree from an artifact's config.json
    (unknown keys are ignored, missing keys keep their defaults)."""
    cfg = default_config()

    def rebuild(template, data):
        if dataclasses.is_dataclass(template) and isinstance(data, dict):
            updates = {}
            for f in dataclasses.fields(template):
                if f.name in data:
                    cur = getattr(template, f.name)
                    new = rebuild(cur, data[f.name])
                    if isinstance(cur, tuple) and isinstance(new, list):
                        new = tuple(new)
                    updates[f.name] = new
            return dataclasses.replace(template, **updates)
        if isinstance(template, tuple) and isinstance(data, list):
            return tuple(tuple(x) if isinstance(x, list) else x for x in data)
        return data

    return rebuild(cfg, d)
