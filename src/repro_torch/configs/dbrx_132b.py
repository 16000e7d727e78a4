"""DBRX-132B [hf:databricks/dbrx-base; unverified]. Fine-grained MoE:
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, 16 experts top-4."""
from repro_torch.models import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100_352, head_dim=128,
        norm="rmsnorm", act="swiglu", rope_theta=500_000.0,
        moe=MoEConfig(n_experts=16, top_k=4, capacity_factor=1.25))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        norm="rmsnorm", act="swiglu",
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5),
        remat=False, loss_chunk=32)
