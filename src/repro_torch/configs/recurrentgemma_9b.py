"""recurrentgemma-9b [hybrid]: 38L d4096 16H (kv=1) d_ff 12288 vocab 256000.

A copy of ``repro/configs/recurrentgemma_9b.py`` [arXiv:2402.19427]:
Griffin, a repeating (RG-LRU, RG-LRU, local-attention) pattern
(attention:recurrent = 1:2), lru_width 4096, local window 2048, GeGLU,
head_dim 256, MQA on the attention layers.  Sub-quadratic: runs long_500k
(RG-LRU state + 2048-token ring cache).
"""

from repro_torch.configs.base import ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        activation="gelu",
        window=2048,
        segments=((("rglru", "rglru", "local"), 12), (("rglru",), 2)),
        rglru=RGLRUConfig(lru_width=4096, d_conv=4),
        tie_embeddings=True,
        embedding_scale=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        n_layers=4,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=192,
        vocab_size=256,
        activation="gelu",
        window=16,
        segments=((("rglru", "rglru", "local"), 1), (("rglru",), 1)),
        rglru=RGLRUConfig(lru_width=64, d_conv=4),
        tie_embeddings=True,
        embedding_scale=True,
        supports_long_context=True,
        remat=False,
    )
