"""rwkv6-7b [ssm] — Finch, data-dependent decay; attention-free. [arXiv:2404.05892]

32L d_model=4096 d_ff=14336 vocab=65536.  WKV6 head size 64 (standard for
Finch); decode state is O(1) so long_500k is native.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # wkv heads = d_model / head_size(64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_state=64,
    tie_embeddings=False,
    source="arXiv:2404.05892",
)
