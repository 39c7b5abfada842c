"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality).

Port of `repro/configs/mamba2_130m.py`.
"""
from ..models.config import ModelConfig, SSMConfig, SubLayer

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,                      # attention-free
    num_kv_heads=0,
    d_ff=0,                           # Mamba blocks have no separate MLP
    vocab_size=50280,
    tie_embeddings=True,
    pattern=(SubLayer(kind="ssm", ffn="none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060; unverified",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
    )
