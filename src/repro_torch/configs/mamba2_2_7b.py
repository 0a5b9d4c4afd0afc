"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMCfg(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    source="arXiv:2405.21060; unverified",
)
