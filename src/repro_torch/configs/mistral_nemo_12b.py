"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(q_dim 4096 < d_model — explicit head_dim), 128k context."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131_072, head_dim=128,
        norm="rmsnorm", act="swiglu", rope_theta=1_000_000.0,
        max_seq=131_072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", family="dense", n_layers=2,
        d_model=96, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
        head_dim=16,  # head_dim*heads != d_model, like the real config
        norm="rmsnorm", act="swiglu", remat=False, loss_chunk=32)
