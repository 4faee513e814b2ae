"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf] — MoE 64e top-6.

Moonlight follows the DeepSeek lineage: first layer dense (dense_d_ff=11264),
2 shared experts."""
from repro_torch.configs.base import ArchConfig, register


@register("moonshot-v1-16b-a3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        groups=((("attn_dense_first",), 1), (("attn_moe",), 47)),
        n_experts=64, top_k=6, n_shared_experts=2, dense_d_ff=11264,
        act="silu", gated_mlp=True, rope_theta=50000.0,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
