"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT frontend + InternLM2-20B.

Backbone only: the InternViT-6B encoder is a stub;
input_specs() delivers precomputed patch embeddings (256 tokens x 3200 after
pixel-shuffle) and the trained 2-layer MLP projector maps them into the LLM.

Port of `repro/configs/internvl2_26b.py`."""
from ..models.config import FrontendConfig, ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    pattern=(SubLayer(kind="attn", ffn="mlp"),),
    frontend=FrontendConfig(modality="vision", d_frontend=3200,
                            num_positions=256),
    source="arXiv:2404.16821; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        frontend=FrontendConfig(modality="vision", d_frontend=48,
                                num_positions=8),
    )
