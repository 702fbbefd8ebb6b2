"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    sliding_window=8192,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
