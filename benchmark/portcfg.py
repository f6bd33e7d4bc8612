"""The port's ``Config`` for a configuration file: its default config with
every key of the file's model sections set to the file's value."""

from __future__ import annotations

import dataclasses

SECTIONS = ("audio", "tacotron", "wavernn", "wavernn_gen", "tacotron_train", "wavernn_train")


def build(conf: dict, patch: dict | None = None):
    """``conf`` is a configuration file's dict; ``patch`` ({section: {key:
    value}}) changes it further (the tests' small sizes)."""
    from tacotronv2_wavernn_chinese_tpu_torch.config import default_config

    cfg = default_config()
    for sec in SECTIONS:
        vals = dict(conf.get(sec, {}))
        vals.update((patch or {}).get(sec, {}))
        if not vals:
            continue
        cur = getattr(cfg, sec)
        fields = {f.name for f in dataclasses.fields(cur)}
        unknown = sorted(set(vals) - fields)
        if unknown:
            raise KeyError(f"{sec}: the port's config has no {unknown}")
        vals = {k: tuple(v) if isinstance(v, list) else v for k, v in vals.items()}
        cfg = dataclasses.replace(cfg, **{sec: dataclasses.replace(cur, **vals)})
    return cfg


def section(conf: dict, name: str, patch: dict | None = None) -> dict:
    """One model section of a configuration file, with ``patch`` applied:
    the widths the work counters and the reference read."""
    out = dict(conf.get(name, {}))
    out.update((patch or {}).get(name, {}))
    return out
