"""phi3-mini-3.8b [arXiv:2404.14219; unverified] — dense, RoPE SwiGLU GQA."""
from repro_torch.configs.base import ArchConfig, register


@register("phi3-mini-3.8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        groups=((("attn",), 32),),
        act="silu", gated_mlp=True, rope_theta=10000.0,
        source="arXiv:2404.14219",
    )
