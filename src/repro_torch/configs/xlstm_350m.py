"""xlstm-350m [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

24 residual blocks alternating (mLSTM, sLSTM); d_ff=0 per the assignment
(blocks carry their own up/down projections, proj_factor=2). Linear-time
recurrence: runs the long_500k shape."""
from repro_torch.configs.base import ArchConfig, register


@register("xlstm-350m")
def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        groups=((("mlstm", "slstm"), 12),),
        head_dim=256, proj_factor=2.0,
        act="gelu", gated_mlp=False, rope_theta=None,
        source="arXiv:2405.04517",
    )
