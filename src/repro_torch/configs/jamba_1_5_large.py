"""Jamba-1.5-Large (398B) [arXiv:2403.19887; hf] — hybrid Mamba+attention.

72 sub-layers = 9 Jamba blocks of 8: attention at in-block index 4 (1:7
attn:mamba interleave), MoE (16 experts, top-2) on odd indices (every other
layer), Mamba elsewhere.

Port of `repro/configs/jamba_1_5_large.py`.
"""
from ..models.config import ModelConfig, MoEConfig, SSMConfig, SubLayer


def _jamba_pattern():
    subs = []
    for i in range(8):
        kind = "attn" if i == 4 else "ssm"
        ffn = "moe" if i % 2 == 1 else "mlp"
        subs.append(SubLayer(kind=kind, ffn=ffn))
    return tuple(subs)


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,                      # dense-MLP layers
    vocab_size=65536,
    rope_theta=1_000_000.0,
    pattern=_jamba_pattern(),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2403.19887; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=8.0),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
    )
