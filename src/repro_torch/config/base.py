"""Config system: frozen dataclasses + registry + CLI helpers.

Every selectable architecture registers a :class:`ModelConfig` under its
``--arch`` id.  Shapes (``--shape``) and meshes (``--mesh``) have their own
small configs.  Everything is hashable/frozen so configs can be closed over
by jitted functions safely.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "audio" | "vlm" | "cnn" | "resnet"


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field names follow the assignment table."""

    name: str
    family: Family
    # transformer geometry
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    # norm / embedding details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 128
    ssm_expand: int = 2
    conv_width: int = 4
    # hybrid (recurrentgemma): periodic block pattern, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 0  # local-attention window for hybrid / sliding-window serving
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30s -> 1500 frames
    # VLM
    cross_attn_every: int = 0  # a cross-attn layer every k-th layer
    num_image_tokens: int = 0
    # CNN / ResNet (paper-faithful models)
    cnn_channels: Tuple[int, ...] = ()
    resnet_blocks: Tuple[int, ...] = ()
    resnet_width: int = 16
    input_hw: Tuple[int, int, int] = (32, 32, 3)
    num_classes: int = 0
    # training policy (per-arch): adafactor for the >=90B configs
    optimizer: str = "adamw"
    # block style
    norm: str = "rms"               # "rms" | "ln"
    ffn: str = "gated"              # "gated" | "mlp"
    # attention blocking (flash-style pure-JAX attention)
    q_block: int = 512
    kv_block: int = 512
    # activation / dtypes
    activation: str = "silu"
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # ProFe / student derivation
    student_scale: float = 0.5      # layers & d_ff scale for the derived student
    student_moe: bool = False       # MoE teacher -> dense student by default
    proto_dim: int = 0              # 0 -> d_model ; dimension of f_1(x) representations
    n_proto_classes: int = 64       # domain-label classes for LM archs
    # serving
    sliding_window_serve: int = 8192  # rolling-KV window used for long_500k
    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.proto_dim == 0:
            object.__setattr__(self, "proto_dim", self.d_model)

    # -- derived ------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Native sub-quadratic decode (constant/windowed state)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced variant used by smoke tests: same family, tiny geometry.
    def smoke(self) -> "ModelConfig":
        kw: Dict[str, Any] = dict(
            num_layers=min(self.num_layers, 2) or self.num_layers,
            d_model=min(self.d_model, 128) if self.d_model else self.d_model,
            d_ff=min(self.d_ff, 256) if self.d_ff else self.d_ff,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else self.vocab_size,
            num_heads=min(self.num_heads, 4) if self.num_heads else self.num_heads,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else self.num_kv_heads,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else self.encoder_seq,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            sliding_window_serve=64,
            cross_attn_every=self.cross_attn_every and 2,
            num_image_tokens=min(self.num_image_tokens, 16) if self.num_image_tokens else 0,
            n_proto_classes=8,
            head_dim=0,
            proto_dim=0 if self.d_model else self.proto_dim,  # re-derive
        )
        if self.block_pattern:
            kw["num_layers"] = len(self.block_pattern)
        if self.num_heads:
            kw["head_dim"] = kw["d_model"] // kw["num_heads"]
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Federation / training configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FederationConfig:
    num_nodes: int = 20
    # Topology spec (core/topology.make_schedule): "full" | "ring" |
    # "star" | "random-k<k>" | "er-<p>" | "dynamic:<a>,<b>,..." |
    # "resample:<sub>"
    topology: str = "full"
    rounds: int = 10
    local_epochs: int = 1
    algorithm: str = "profe"        # "profe"|"fedavg"|"fedproto"|"fml"|"fedgpd"
    # ProFe hyper-parameters (Sec. III)
    kd_temperature: float = 3.0
    alpha_s: float = 0.7            # distillation weight, halved per round
    alpha_limit: float = 0.05       # beta_limit in the paper
    beta_s: float = 1.0             # prototype-MSE weight (student)
    beta_t: float = 1.0             # prototype-MSE weight (teacher)
    quantize_bits: int = 16
    # wire width of the prototypes when it differs from the student
    # (None follows quantize_bits) — e.g. the mixed-precision wire
    # (int4 student + int16 prototypes) is quantize_bits=4,
    # proto_quantize_bits=16; both feed one repro.wirespec.WireSpec
    proto_quantize_bits: Optional[int] = None
    # stateful wire codec: each node carries the quantization residual
    # of its last payload and replays it into the next round (error
    # feedback à la CEFD) — recovers most of the sub-byte wire's F1
    # cost at ZERO extra wire bytes.  error_feedback_decay scales the
    # carried residual before it re-enters the payload (1.0 = full EF).
    # Both route through _algo_wiring into the WireSpec.
    error_feedback: bool = False
    error_feedback_decay: float = 1.0
    # adapter-rank wire (core/adapters.py): rank > 0 replaces each
    # matrix leaf's dense payload with per-round low-rank delta factors
    # (B: [d, r], A: [r, k]) riding the "adapters" payload group —
    # O(r·(d+k)) wire per matrix instead of O(d·k).  Aggregation
    # becomes merge-based (RegMean when adapter_grams, naive weighted
    # factor averaging otherwise); non-matrix leaves stay dense in the
    # "student" group.  adapter_quantize_bits / gram_quantize_bits pin
    # the wire width of the factor / gram groups (None follows
    # quantize_bits) — all four feed the one WireSpec.
    adapter_rank: int = 0
    adapter_grams: bool = False
    adapter_quantize_bits: Optional[int] = None
    gram_quantize_bits: Optional[int] = None
    # Eq. 3 prototype pass: "exact" streams every node's local data a
    # SECOND time after local training (the paper's post-training pass,
    # bit-identical to the historical engines); "fused" accumulates the
    # per-class sums/counts inside the training scan from the f1
    # features the student loss already computes — one forward pass per
    # node per round instead of two, at the cost of prototypes built
    # from the evolving (pre-final) student (F1 delta recorded in
    # reports/fig2_f1_proto_pass.json).
    proto_pass: str = "exact"       # "exact" | "fused"
    # EMA prototype carry across rounds (fused-pass follow-up): decay
    # on last round's raw Eq. 3 accumulators (sums, counts) blended
    # into this round's before normalization — 0.0 (default) is off
    # (current-round prototypes only); 0 < proto_ema < 1 carries
    # `ema * prev + new`, smoothing the evolving-student bias of the
    # fused pass and sparse-data rounds of the exact pass alike.
    proto_ema: float = 0.0
    # flat parameter plane (optim/plane.py): "auto" packs the student
    # into one contiguous fp32 [R, 512] buffer with a fused clip+update
    # sweep whenever the algorithm/optimizer/dtypes support it (profe +
    # sgd/adamw + all-float32 student); "on" requires it (ValueError
    # otherwise); "off" keeps the per-leaf reference everywhere.
    param_plane: str = "auto"       # "auto" | "on" | "off"
    # data split
    split: str = "iid"              # "iid"|"noniid60"|"noniid40"|"noniid20"|"dirichlet"
    dirichlet_alpha: float = 0.5
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    learning_rate: float = 1e-3
    optimizer: str = "adamw"        # "adamw" | "sgd" | "adafactor"
    weight_decay: float = 0.01
    momentum: float = 0.9
    warmup_steps: int = 0
    total_steps: int = 1000
    grad_clip: float = 1.0
    remat: bool = True
    microbatches: int = 1   # gradient accumulation (activation memory / m)
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]
