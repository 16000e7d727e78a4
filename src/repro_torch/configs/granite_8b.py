"""Granite-8B-Code [arXiv:2405.04324; hf]. Llama-arch:
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152, head_dim=128."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49_152, head_dim=128,
        norm="rmsnorm", act="swiglu", rope_theta=10_000_000.0,
        tie_embeddings=True)  # granite-code ties embeddings


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        norm="rmsnorm", act="swiglu", tie_embeddings=True, remat=False,
        loss_chunk=32)
