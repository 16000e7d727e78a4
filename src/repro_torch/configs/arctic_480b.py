"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base; hf].
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP (dense-MoE hybrid)."""
from repro_torch.models import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32_000, head_dim=128,
        norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
        moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                      residual_ffn_dim=4864))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab=512, head_dim=16,
        norm="rmsnorm", act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.5,
                      residual_ffn_dim=96),
        remat=False, loss_chunk=32)
