"""Model configuration for every supported architecture family.

A copy of ``repro.models.config`` with the same fields, so that one config
moves between the two packages unchanged.  A single dataclass covers all six
families (dense / moe / ssm / hybrid / encdec / vlm); family-specific fields
are ignored by the others.  Configs are plain frozen dataclasses so they
hash.

``attn_impl`` keeps the JAX package's two names.  In this package
``"pallas"`` means the prefill's hand-written Hopper kernel
(``repro_torch.kernels.flash_attention``, or ``rwkv6_scan`` for the ssm
family) on a CUDA tensor, and its plain PyTorch version on a CPU tensor;
``"xla"`` means the plain path (the einsum attention, the sequential
scan).
The mesh fields are read only when the model's tensors are DTensors on
a mesh (the dry run, ``repro_torch.launch.dryrun``): ``seq_shard_axis``
pins the residual stream's sequence dim between blocks
(``models.model``), ``moe_expert_axis`` and ``batch_shard_axes`` pin the
grouped MoE buffer (``models.moe``).  On plain tensors they change
nothing.  ``remat`` checkpoints each block while the model trains.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ARCH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of ARCH_FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                      # query heads (0 for attn-free ssm)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # --- attention ---
    qkv_bias: bool = False            # qwen2.5 style
    rope_theta: float = 10000.0
    sliding_window: int = 0           # 0 = full attention; >0 = SWA window
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM / hybrid ---
    ssm_state: int = 0                # mamba/rwkv per-head state size
    # --- encoder (encdec / vlm frontends, stubbed upstream) ---
    enc_layers: int = 0               # whisper encoder depth
    enc_seq: int = 0                  # audio frames / image patches
    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "xla"            # "xla" | "pallas" (hand-written kernel)
    # §Perf: Megatron-style sequence parallelism — constrain the residual
    # stream's sequence dim to the named mesh axis between blocks, turning
    # per-layer all-reduces into reduce-scatter + all-gather pairs and
    # sharding the norm/residual math.  "" disables (paper-faithful
    # baseline); the launcher enables it for the optimized configs.
    seq_shard_axis: str = ""
    # §Perf: pin the MoE dispatch buffer's expert dim to this mesh axis so
    # dispatch is shard-local and only the combine psum crosses devices.
    moe_expert_axis: str = ""
    # §Perf: mesh axes carrying the global batch (e.g. ("data",) or
    # ("pod", "data")) — used to pin scatter/gather intermediates whose
    # batch sharding GSPMD loses (the MoE dispatch buffer).
    batch_shard_axes: tuple = ()
    # §Perf: KV-cache storage dtype ("" = model dtype | "bfloat16" |
    # "float8_e4m3fn") — fp8 halves the decode memory term; K/V are
    # upcast on read.
    kv_cache_dtype: str = ""
    source: str = ""                  # citation bracket from the assignment

    def __post_init__(self):
        if self.family not in ARCH_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived sizes ------------------------------------------------
    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used by roofline + scheduler PMI)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = 0
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o + decay lora) + channel-mix
            per_layer = 4 * d * d + 2 * d * 64 + d * f + f * d + d * d
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.family == "moe":
                ffn = self.n_experts * 3 * d * f
            else:
                ffn = 3 * d * f
            per_layer = attn + ffn
            if self.family == "hybrid":
                # extra mamba path ~ 2*d*2d (in/out proj) + small scan params
                per_layer += 4 * d * d + 2 * d * self.ssm_state
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.enc_layers:
            enc = self.enc_layers * (4 * d * d + 2 * d * f)
            if self.family == "encdec":  # decoder cross-attn
                per_layer += 4 * d * d
        return self.n_layers * per_layer + emb + enc

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE uses top_k of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * f
        )
        return dense_like + self.n_layers * self.top_k * 3 * d * f

    def reduced(self, n_layers: int = 2, max_d_model: int = 512,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant of the same family (2 layers, d_model<=512)."""
        scale = min(1.0, max_d_model / self.d_model)
        d_model = max(64, int(self.d_model * scale) // 64 * 64)
        n_heads = max(1, min(self.n_heads, 4)) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        head_dim = d_model // n_heads if n_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 2 * d_model),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, max_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
