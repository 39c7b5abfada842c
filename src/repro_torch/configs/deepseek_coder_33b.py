"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — llama-arch dense, GQA kv=8.

Port of `repro/configs/deepseek_coder_33b.py`."""
from ..models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    pattern=(SubLayer(kind="attn", ffn="mlp"),),
    source="arXiv:2401.14196; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=256,
    )
