"""Minitron-4B: width-pruned Nemotron [arXiv:2407.14679; hf].
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, head_dim=128."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, d_ff=9216, vocab=256_000, head_dim=128,
        norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
        loss_chunk=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        norm="rmsnorm", act="swiglu", remat=False, loss_chunk=32)
