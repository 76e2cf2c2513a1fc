"""Hyperparameters of the model, the trainer, the data, retrieval and
serving, plus shared shape arithmetic.

Copies of ``hhrs_tpu/config.py``'s ``ModelConfig``, ``TrainConfig``,
``MeshConfig``, ``DataConfig``, ``RetrievalConfig`` and ``ServeConfig``
(same fields and defaults), of the ``section.field=value`` overrides of
``Config.apply_overrides``, of the layered assembly the CLIs use
(``PRESETS``, ``apply_preset``, ``apply_env_overrides``,
``check_overrides``, ``build_config``: defaults → preset → ``HHRS_*``
environment → CLI tokens), and of ``hhrs_tpu/utils/shapes.py::round_up``.
An artifact manifest's ``model_config`` loads into :class:`ModelConfig`
field for field; :func:`check_dtypes` holds its dtypes to the JAX model's
rules.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return -(-x // m) * m


@dataclass
class ModelConfig:
    """DCN-R hyperparameters (same fields and defaults as the JAX package)."""

    emb_dim: int = 16
    hidden_dim: int = 128
    n_cross_layers: int = 2
    n_res_blocks: int = 1
    dropout: float = 0.6
    # 'dcnr' | 'cross_only' | 'deep_only' | 'dcn_mlp'
    arch: str = "dcnr"
    # 'code': x += x*(w·x) + b ; 'canonical': x = x0*(w·x) + b + x
    cross_variant: str = "code"
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"

    def cat_emb_dim(self, n_cat: int) -> int:
        # floor(sqrt(n)) + 1, the reference heuristic
        return int(n_cat**0.5) + 1


def check_dtypes(cfg: ModelConfig) -> None:
    """The dtype rules of ``hhrs_tpu/models/dcn.py::apply_dcn_from_x0``, with
    its wording: ``compute_dtype`` and ``storage_dtype`` are each
    ``float32`` or ``bfloat16``, and bf16 storage needs bf16 compute."""
    for name in ("compute_dtype", "storage_dtype"):
        value = getattr(cfg, name)
        if value not in ("float32", "bfloat16"):
            raise ValueError(f"unknown model.{name} {value!r}; expected 'float32' or 'bfloat16'")
    if cfg.storage_dtype == "bfloat16" and cfg.compute_dtype != "bfloat16":
        raise ValueError(
            "model.storage_dtype='bfloat16' requires "
            "model.compute_dtype='bfloat16' (bf16-stored activations imply "
            "bf16 matmul inputs)"
        )


@dataclass
class TrainConfig:
    """Training-loop hyperparameters (same fields and defaults as the JAX
    package; see that file for what each one does there)."""

    lr: float = 1e-3
    batch_size: int = 512
    weight_decay: float = 1e-4
    optimizer: str = "adamw"  # 'adamw' (decoupled) or 'adam' (L2-coupled)
    n_epochs: int = 50
    early_stop_patience: int = 5
    lr_plateau_patience: int = 2
    lr_plateau_factor: float = 0.5
    seed: int = 42
    drop_remainder: bool = True
    eval_batch_size: int = 8192
    lazy_table_updates: bool = False
    rng_impl: str = "threefry2x32"
    moment_dtype: str = "float32"
    eval_every: int = 1
    mesh_resident_data: bool = False
    debug_nans: bool = False
    fused_epoch: bool = False
    stream_slab_steps: int = 0
    eval_catalog_recall: bool = False


@dataclass
class MeshConfig:
    """The device-mesh layout (same fields and defaults as the JAX
    package). The train CLI reads ``explicit_exchange`` and
    ``exchange_capacity_factor``; the mesh itself comes from ``--mesh``."""

    data_axis: int = -1
    model_axis: int = 1
    axis_names: tuple = ("data", "model")
    explicit_exchange: str = ""
    exchange_capacity_factor: float = 1.25


@dataclass
class DataConfig:
    """Column contract of the hackathon CSV and the preprocessing knobs."""

    user_col: str = "user_id"
    item_col: str = "item_id"
    target_col: str = "was_booked"
    raw_user_col: str = "guest_id"
    raw_item_col: str = "hotel_id"
    categorical_cols: tuple = ("city", "hotel_type")
    numerical_cols: tuple = (
        "price_rub",
        "stars",
        "user_reviews_count",
        "rating_overall",
        "rating_location",
        "rating_cleanliness",
        "rating_food",
        "rating_service",
        "price_per_star",
        "cleanliness_vs_service",
        "location_premium",
    )
    positive_rating: float = 8.0
    negative_rating: float = 4.0
    test_size: float = 0.2
    split_seed: int = 42
    # the reference's scaler-fit-before-split quirk, kept for metric parity
    leakage_compat: bool = True


@dataclass
class RetrievalConfig:
    """Candidate-generation knobs."""

    knn_neighbors: int = 16
    expand_neighbors: int = 10  # per-positive kNN expansion, excluding self
    min_candidates: int = 20  # popularity-fallback trigger
    popular_pool: int = 100  # top-N city rows by review count
    mmr_top_k: int = 20  # MMR output size


@dataclass
class ServeConfig:
    """Serving knobs (same fields and defaults as the JAX package; the
    serve CLI's flags override them)."""

    host: str = "0.0.0.0"
    port: int = 8000
    artifacts_dir: str = "artifacts"
    data_dir: str = "data"
    batch_window_ms: float = 0.0  # > 0: dynamic batching (serve/batcher.py)
    max_batch: int = 8
    quantize_tables: bool = False
    candidate_cap: int = 0
    cache_entries: int = 0  # > 0: LRU response cache (serve/cache.py)
    cache_ttl_s: float = 0.0
    data_poll_s: float = 0.0  # > 0: data hot reload (serve/reload.py)
    city_bounded: bool = True
    use_pallas: bool = False  # retired in the JAX engine; a no-op


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def apply_overrides(self, overrides: list) -> "Config":
        """Apply ``section.field=value`` overrides in place."""
        for ov in overrides:
            key, eq, raw = ov.partition("=")
            if not eq:
                raise ValueError(f"override must be section.field=value, got {ov!r}")
            section_name, _, field_name = key.partition(".")
            sections = [f.name for f in dataclasses.fields(self)]
            if section_name not in sections:
                raise ValueError(f"unknown config section {section_name!r} in {ov!r}; "
                                 f"the port has {sections}")
            section = getattr(self, section_name)
            if not hasattr(section, field_name):
                raise ValueError(f"section {section_name!r} has no field {field_name!r}")
            setattr(section, field_name, _coerce(raw, getattr(section, field_name)))
        return self


def _coerce(raw: str, like: Any) -> Any:
    if isinstance(like, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(raw)
    if isinstance(like, float):
        return float(raw)
    if isinstance(like, tuple):
        return tuple(x.strip() for x in raw.split(","))
    return raw


def check_overrides(tokens: list) -> list:
    """Every positional token must be ``section.field=value``: a typo'd token
    fails loudly instead of running with defaults."""
    bad = [t for t in tokens if "=" not in t]
    if bad:
        raise SystemExit(f"invalid config override(s) {bad}: use section.field=value")
    return tokens


def from_cli(argv: list) -> Config:
    """The defaults with ``section.field=value`` tokens applied (a token
    without ``=`` exits, as :func:`check_overrides`)."""
    return Config().apply_overrides(check_overrides(list(argv)))


# Named presets, applied before the environment and the CLI tokens (which
# win over them): ``tuned`` is the JAX package's fastest measured trainer
# stack, ``reference`` the defaults by name.
PRESETS: dict[str, dict[str, Any]] = {
    "tuned": {
        "train.batch_size": 32768,
        "train.rng_impl": "rbg",
        "model.compute_dtype": "bfloat16",
        "model.storage_dtype": "bfloat16",
    },
    "reference": {},
}


def apply_preset(cfg: Config, name: str) -> list[str]:
    """Apply a named preset in place → the changes, for the log."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    changed = []
    for key, value in PRESETS[name].items():
        section_name, _, field_name = key.partition(".")
        section = getattr(cfg, section_name)
        old = getattr(section, field_name)
        setattr(section, field_name, value)
        changed.append(f"{key}: {old!r} -> {value!r}")
    return changed


_ENV_PREFIX = "HHRS_"


def apply_env_overrides(cfg: Config, environ=None) -> list[str]:
    """Apply ``HHRS_<SECTION>_<FIELD>=value`` environment overrides in place
    → the applied overrides, for the log. The section is the longest known
    prefix (field names hold underscores); an unknown ``HHRS_*`` variable
    raises ``ValueError``; ``HHRS_PRESET`` (read by :func:`build_config`)
    and ``HHRS_BENCH_*`` (the JAX benchmark's knobs) are exempt."""
    environ = os.environ if environ is None else environ
    sections = {f.name for f in dataclasses.fields(cfg)}
    applied = []
    for var in sorted(environ):
        if not var.startswith(_ENV_PREFIX):
            continue
        rest = var[len(_ENV_PREFIX):].lower()
        if rest == "preset" or rest.startswith("bench_"):
            continue
        section_name = next((s for s in sorted(sections, key=len, reverse=True) if rest.startswith(s + "_")),
                            None)
        if section_name is None:
            raise ValueError(f"unknown config environment variable {var} (sections: {sorted(sections)})")
        field_name = rest[len(section_name) + 1:]
        section = getattr(cfg, section_name)
        if not hasattr(section, field_name):
            raise ValueError(f"{var}: section {section_name!r} has no field {field_name!r}")
        setattr(section, field_name, _coerce(environ[var], getattr(section, field_name)))
        applied.append(f"{section_name}.{field_name}={environ[var]}")
    return applied


def build_config(overrides: list | None = None, preset: str | None = None, environ=None, log=None) -> Config:
    """The CLIs' config: defaults → preset (``preset`` or ``HHRS_PRESET``)
    → ``HHRS_*`` environment → ``section.field=value`` tokens (last wins)."""
    environ = os.environ if environ is None else environ
    cfg = Config()
    preset = preset or environ.get("HHRS_PRESET") or ""
    if preset:
        changed = apply_preset(cfg, preset)
        if log is not None:
            for c in changed:
                log.info("preset %r: %s", preset, c)
            if not changed:
                log.info("preset %r: no changes (reference defaults)", preset)
    applied = apply_env_overrides(cfg, environ)
    if log is not None:
        for a in applied:
            log.info("env override: %s", a)
    cfg.apply_overrides(check_overrides(list(overrides or [])))
    return cfg
