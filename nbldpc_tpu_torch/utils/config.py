"""Frozen dataclass configs + JSON/TOML loading + config hashing.

Field for field the same dataclasses as the JAX package's
nbldpc_tpu/utils/config.py, so configs/*.json load in both packages and
RunConfig.config_hash() is equal across them (checkpoints carry it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional, Sequence

CODES_DIR = Path(__file__).resolve().parents[2] / "codes"


@dataclasses.dataclass(frozen=True)
class CodeConfig:
    path: Optional[str] = None      # alist file (takes precedence)
    name: Optional[str] = None      # standard code name: codes/<name>.alist

    def load(self):
        """The code: the alist at `path`, else codes/<name>.alist, else the
        standard code `name` generated (KeyError for an unknown name)."""
        from nbldpc_tpu_torch.code import load_alist

        if self.path:
            return load_alist(self.path)
        if self.name:
            std = CODES_DIR / f"{self.name}.alist"
            if std.exists():
                return load_alist(std)
            from nbldpc_tpu_torch.codegen import build_standard_code

            return build_standard_code(self.name)
        raise ValueError("CodeConfig needs path or name")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    kind: str = "qspa"              # qspa | ems | tems
    max_iters: int = 20
    early_term: bool = True
    nm: int = 16                    # EMS truncation
    offset: float = 0.0             # EMS/T-EMS offset correction
    ems_merge: str = "classic"      # EMS CN merge: "classic" | "bubble"
    tems_nr: int = 0                # T-EMS truncated-deviation rows (0 = exact)
    mm_precision: str = "f32"       # message dtype: "f32" | "bf16"
    stats_each_iter: bool = True    # per-iteration decisions in fixed-budget
                                    # mode; False = throughput mode


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    ebn0_db: Sequence[float] = (2.5,)
    zero_codeword: bool = True      # all-zero shortcut (symmetric channel)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    frames_per_step: int = 256      # global per-SNR batch a step, across all ranks
    max_frames: int = 10_000        # stop criterion per SNR point
    max_frame_errors: int = 100     # stop criterion per SNR point
    seed: int = 0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0       # macro-batches; 0 = off
    profile_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    snr: int = 1                    # devices along the 'snr' axis
    data: int = 0                   # devices along 'data'; 0 = all remaining


@dataclasses.dataclass(frozen=True)
class RunConfig:
    code: CodeConfig = CodeConfig(name="gf16_n204_k102")
    decoder: DecoderConfig = DecoderConfig()
    channel: ChannelConfig = ChannelConfig()
    sim: SimConfig = SimConfig()
    mesh: MeshConfig = MeshConfig()

    def config_hash(self) -> str:
        return hashlib.sha256(
            json.dumps(dataclasses.asdict(self), sort_keys=True, default=list).encode()
        ).hexdigest()[:16]


_RESOLVE = {
    "code": CodeConfig,
    "decoder": DecoderConfig,
    "channel": ChannelConfig,
    "sim": SimConfig,
    "mesh": MeshConfig,
}


def _build(cls, data: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise ValueError(f"unknown config key {cls.__name__}.{k}")
        if dataclasses.is_dataclass(_RESOLVE.get(k)):
            v = _build(_RESOLVE[k], v)
        kwargs[k] = v
    return cls(**kwargs)


def load_config(path) -> RunConfig:
    """Load RunConfig from a JSON or TOML file."""
    text = Path(path).read_text()
    if str(path).endswith(".toml"):
        import tomllib

        data = tomllib.loads(text)
    else:
        data = json.loads(text)
    return _build(RunConfig, data)


def apply_overrides(cfg: RunConfig, overrides: Sequence[str]) -> RunConfig:
    """Apply 'a.b=value' CLI overrides (JSON-parsed values)."""
    data = dataclasses.asdict(cfg)
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = key.split(".")
        d = data
        for i, p in enumerate(parts[:-1]):
            if p not in d:
                raise ValueError(
                    f"unknown config key {'.'.join(parts[: i + 1])!r} in override {ov!r}"
                )
            d = d[p]
        if parts[-1] not in d:
            raise ValueError(f"unknown config key {key!r} in override {ov!r}")
        try:
            d[parts[-1]] = json.loads(val)
        except json.JSONDecodeError:
            d[parts[-1]] = val
    return _build(RunConfig, data)
