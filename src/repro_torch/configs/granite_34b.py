"""granite-34b [dense] — llama-arch, code; MQA (kv=1). [arXiv:2405.04324]

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    sliding_window=8192,
    tie_embeddings=True,
    source="arXiv:2405.04324",
)
