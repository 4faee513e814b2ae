"""whisper-small [arXiv:2212.04356; unverified] — enc-dec audio backbone.

The conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, 1500, d). Shapes (train/prefill/decode seq
lens) apply to the DECODER stream; the encoder always sees 1500 frames.
12 heads do not divide the 16-way model axis -> attention params replicate on
"model"; d_ff (3072 = 16*192) carries the TP (DESIGN.md §6)."""
from repro_torch.configs.base import ArchConfig, register


@register("whisper-small")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        groups=((("dec_xattn",), 12),),
        n_enc_layers=12, enc_context=1500,
        norm="layernorm", act="gelu", gated_mlp=False, attn_bias=True,
        rope_theta=None,   # sinusoidal absolute positions
        source="arXiv:2212.04356",
    )
