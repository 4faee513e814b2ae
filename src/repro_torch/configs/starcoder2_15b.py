"""starcoder2-15b [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE, gelu MLP,
layernorm + attention bias (per the HF config)."""
from repro_torch.configs.base import ArchConfig, register


@register("starcoder2-15b")
def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        groups=((("attn",), 40),),
        norm="layernorm", act="gelu_tanh", gated_mlp=False, attn_bias=True,
        rope_theta=100000.0,
        source="arXiv:2402.19173",
    )
