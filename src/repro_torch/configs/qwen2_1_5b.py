"""Qwen2-1.5B [arXiv:2407.10671; hf] — dense, GQA (kv=2), QKV bias.

Port of `repro/configs/qwen2_1_5b.py`."""
from ..models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pattern=(SubLayer(kind="attn", ffn="mlp"),),
    tie_embeddings=True,           # Qwen2-1.5B ties embeddings
    source="arXiv:2407.10671; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
    )
