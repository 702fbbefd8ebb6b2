"""whisper-tiny [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356]

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.  The mel-spectrogram +
conv feature extractor is a stub: input_specs() provides precomputed frame
embeddings of shape (B, 1500, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    enc_layers=4,
    enc_seq=1500,
    rope_theta=0.0,          # whisper uses learned/sinusoidal pos, not RoPE
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
