"""Mamba2-1.3B [arXiv:2405.21060; unverified]. Attention-free SSD:
48L d_model=2048 vocab=50280, ssm_state=128, headdim=64, expand=2."""
from repro_torch.models import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50_280, head_dim=0,
        norm="rmsnorm",
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk=128),
        tie_embeddings=True, sub_quadratic=True, max_seq=1_048_576)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=512, head_dim=0,
        norm="rmsnorm",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      chunk=16),
        tie_embeddings=True, sub_quadratic=True, remat=False,
        loss_chunk=32)
