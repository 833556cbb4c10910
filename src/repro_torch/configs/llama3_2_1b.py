"""llama3.2-1b [dense]: 16L d2048 32H (GQA kv=8) d_ff 8192 vocab 128256.

A copy of ``repro/configs/llama3_2_1b.py``: small llama3 with SwiGLU, RoPE
theta 500k, tied embeddings, head_dim 64.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
        activation="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        rope_theta=500000.0,
        tie_embeddings=True,
        remat=False,
    )
