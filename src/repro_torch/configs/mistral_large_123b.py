"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified].
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768, head_dim=128."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense", n_layers=88,
        d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672, vocab=32_768,
        head_dim=128, norm="rmsnorm", act="swiglu",
        rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke", family="dense", n_layers=3,
        d_model=96, n_heads=6, n_kv_heads=2, d_ff=192, vocab=512,
        head_dim=16, norm="rmsnorm", act="swiglu", remat=False,
        loss_chunk=32)
