"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified] — trillion-param MoE.

Assigned spec: 61L, d=7168, 64H (GQA kv=8), expert d_ff=2048, vocab 163840,
384 experts top-8. DeepSeek-lineage details we adopt: first layer dense
(dense_d_ff=18432), 1 shared expert. The real K2 uses MLA attention; the
assignment specifies GQA kv=8, which we follow (deviation noted here and in
DESIGN.md)."""
from repro_torch.configs.base import ArchConfig, register


@register("kimi-k2-1t-a32b")
def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab_size=163840,
        groups=((("attn_dense_first",), 1), (("attn_moe",), 60)),
        head_dim=112, n_experts=384, top_k=8, n_shared_experts=1,
        dense_d_ff=18432,
        act="silu", gated_mlp=True, rope_theta=50000.0,
        source="arXiv:2501.kimi2",
    )
