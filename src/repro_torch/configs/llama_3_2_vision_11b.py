"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Text backbone: 40 decoder layers with 8 gated cross-attention layers
interleaved 1-per-4 self-attn (pattern (self x4, xattn) x 8). The vision
tower is a STUB per the assignment: input_specs() provides precomputed patch
embeddings (B, n_img_tokens=1600, d)."""
from repro_torch.configs.base import ArchConfig, register


@register("llama-3.2-vision-11b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        groups=((("attn", "attn", "attn", "attn", "xattn"), 8),),
        n_img_tokens=1600,
        act="silu", gated_mlp=True, rope_theta=500000.0,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
