"""granite-3-8b [hf:ibm-granite/granite-3.0; hf] — dense GQA kv=8.

vocab 49155 is not divisible by the 16-way model axis; padded to 49408
(ArchConfig.vocab_padded) with logits masked — see DESIGN.md §6."""
from repro_torch.configs.base import ArchConfig, register


@register("granite-3-8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab_size=49155,
        groups=((("attn",), 40),),
        act="silu", gated_mlp=True, rope_theta=10000.0,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
