"""Zamba2-2.7B [arXiv:2411.15242; hf]. Hybrid: Mamba2 backbone with a
SHARED attention+MLP block applied every 6 SSD blocks (param tying):
54L d_model=2560, shared attn 32H (kv=32, MHA) d_ff=10240, ssm_state=64."""
from repro_torch.models import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32_000, head_dim=80,
        norm="rmsnorm", act="swiglu",
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                      chunk=128),
        shared_attn_every=6, tie_embeddings=True, sub_quadratic=True,
        max_seq=1_048_576)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
        norm="rmsnorm", act="swiglu",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      chunk=16),
        shared_attn_every=2, tie_embeddings=True, sub_quadratic=True,
        remat=False, loss_chunk=32)
