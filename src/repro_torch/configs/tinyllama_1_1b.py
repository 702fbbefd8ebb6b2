"""tinyllama-1.1b [dense] — llama2-arch small. [arXiv:2401.02385]

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    sliding_window=8192,     # enables the long_500k SWA variant
    tie_embeddings=False,
    source="arXiv:2401.02385",
)
