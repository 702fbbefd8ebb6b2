"""internvl2-2b [vlm] — InternViT + InternLM2 backbone. [arXiv:2404.16821]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The ViT/projector is
a stub: input_specs() provides projected patch embeddings (B, 256, d_model)
interleaved ahead of the text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    enc_seq=256,             # image patch tokens supplied by the stub
    sliding_window=8192,
    tie_embeddings=False,
    source="arXiv:2404.16821",
)
