"""InternLM2-20B [arXiv:2403.17297; hf] — dense, GQA kv=8.

Port of `repro/configs/internlm2_20b.py`."""
from ..models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    pattern=(SubLayer(kind="attn", ffn="mlp"),),
    source="arXiv:2403.17297; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=4,
        d_ff=128, vocab_size=256,
    )
