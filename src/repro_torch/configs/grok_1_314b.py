"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    sliding_window=8192,
    tie_embeddings=False,
    source="hf:xai-org/grok-1",
)
