"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from repro_torch.configs.base import ArchConfig, register


@register("mistral-large-123b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=28672, vocab_size=32768,
        groups=((("attn",), 88),),
        head_dim=128, act="silu", gated_mlp=True, rope_theta=1000000.0,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
