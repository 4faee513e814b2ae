"""recurrentgemma-9b [arXiv:2402.19427; unverified] — RG-LRU + local attn.

Griffin pattern (R, R, A) tiled 12x (36 layers) + 2 trailing recurrent
layers = 38L (the assigned count; deviation from exact-(RRA)*k noted in
DESIGN.md). Local attention window 2048, MQA (kv=1, replicated on "model").
Long-context decode is O(window + state): runs the long_500k shape."""
from repro_torch.configs.base import ArchConfig, register


@register("recurrentgemma-9b")
def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000,
        groups=((("rglru", "rglru", "local_attn"), 12), (("rglru",), 2)),
        head_dim=256, lru_width=4096, window=2048,
        act="gelu_tanh", gated_mlp=True, rope_theta=10000.0,
        source="arXiv:2402.19427",
    )
