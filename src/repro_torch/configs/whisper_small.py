"""Whisper-small — encoder-decoder audio transformer; conv frontend is a
STUB (input_specs provides precomputed frame embeddings)
[arXiv:2212.04356; unverified].
"""
from repro_torch.configs.base import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    rope_theta=1e4,  # (whisper uses learned abs pos; rope unused for enc)
    enc_dec=EncDecCfg(n_enc_layers=12, enc_seq=1500),
    source="arXiv:2212.04356; unverified",
)
