"""qwen3-8b [hf:Qwen/Qwen3-8B; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, qk-norm.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_base=1000000.0,
    subquadratic=False,
))
