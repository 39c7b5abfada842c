"""MusicGen-Large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

Backbone only: the EnCodec tokenizer and T5 text conditioning are stubs.
The 4 RVQ codebooks are summed at input (4 embedding tables) and predicted
with 4 output heads over the 2048-entry codebook (delay pattern handled by
the data pipeline, not the backbone).

Port of `repro/configs/musicgen_large.py`."""
from ..models.config import FrontendConfig, ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,                  # MHA
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    pattern=(SubLayer(kind="attn", ffn="mlp"),),
    frontend=FrontendConfig(modality="audio", num_positions=4),
    source="arXiv:2306.05284; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=64,
        frontend=FrontendConfig(modality="audio", num_positions=4),
    )
