"""Yi-6B [arXiv:2403.04652; hf] — llama-arch dense, GQA kv=4.

Port of `repro/configs/yi_6b.py`."""
from ..models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    pattern=(SubLayer(kind="attn", ffn="mlp"),),
    source="arXiv:2403.04652; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=4,
        d_ff=128, vocab_size=256,
    )
