"""mamba2-2.7b [ssm]: 64L d2560, attention-free, SSD state 128, vocab 50280.

A copy of ``repro/configs/mamba2_2_7b.py`` [arXiv:2405.21060]: state-space
duality, d_inner = 2*d_model = 5120, head_dim 64 (80 heads), 1 B/C group,
conv4.  Sub-quadratic: runs the long_500k cell (O(1)-state decode).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        n_layers=64,
        d_model=2560,
        n_heads=80,  # d_inner / head_dim
        n_kv_heads=80,
        d_ff=0,
        head_dim=64,
        vocab_size=50280,
        segments=((("ssm",), 64),),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        head_dim=32,
        vocab_size=256,
        segments=((("ssm",), 2),),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1,
                      chunk_size=16),
        supports_long_context=True,
        remat=False,
    )
