"""hymba-1.5b [hybrid] — parallel attn+mamba heads. [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Meta-tokens are omitted (noted in DESIGN.md); attention path uses SWA as in
the paper's global/local mix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    sliding_window=2048,
    tie_embeddings=True,
    source="arXiv:2411.13676",
)
