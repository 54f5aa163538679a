"""llada-8b — the paper's model family: masked diffusion LM [LLaDA].

Llama2-7B-like bidirectional transformer used as the MDLM mask predictor:
32L d_model=4096 32H (MHA) d_ff=12288 vocab=126464.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llada-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=12288,
        vocab_size=126464,
        rope_theta=5.0e5,
    )
