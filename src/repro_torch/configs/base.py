"""Architecture config schema + registry.

The port's copy of ``repro.configs.base``, field for field: each assigned
architecture has one file in ``repro_torch/configs/`` defining an
``ArchConfig`` with the assigned hyperparameters, plus a ``reduced()``
variant used by CPU smoke tests.

Block patterns: the model is a sequence of *groups*; each group is
``(pattern, count)`` where pattern is a tuple of block-type names executed in
order, and the group repeats ``count`` times (one module a layer in the
port, a Python loop over them).
Block types: "attn" (self-attn + MLP), "attn_moe" (self-attn + MoE),
"enc" (bidirectional attn + MLP), "dec_xattn" (self + cross + MLP),
"xattn" (gated cross-attn + MLP), "rglru" (RG-LRU + MLP),
"local_attn" (windowed self-attn + MLP), "mlstm", "slstm".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

Pattern = Tuple[Tuple[str, ...], int]


def _pad256(v: int) -> int:
    return ((v + 255) // 256) * 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: Tuple[Pattern, ...]       # block-pattern groups (see module doc)

    head_dim: int = 0                 # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    attn_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    dense_d_ff: int = 0               # first dense layer(s) of MoE stacks
    capacity_factor: float = 1.25

    # hybrid / ssm
    window: int = 0                   # sliding-window size for local attn
    lru_width: int = 0
    proj_factor: float = 2.0          # xLSTM up-projection

    # enc-dec / vlm frontends (stubs provide precomputed embeddings)
    n_enc_layers: int = 0
    enc_context: int = 0              # whisper: 1500 frames
    n_img_tokens: int = 0             # vlm: image patch tokens

    # runtime
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"        # full | save_attn_out (hillclimb lever)
    attn_scores_dtype: str = "float32"  # float32 | bfloat16 (hillclimb lever)
    sketched_mlp: bool = False        # SMP-PCA gradient taps on MLP matmuls
    constrain_activations: bool = False  # sharding constraints in scans
    loss_chunk: int = 512             # seq-chunked softmax-xent (vocab is big)
    aux_loss_weight: float = 0.01

    # citation / provenance
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return _pad256(self.vocab_size)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode cost is O(1) in context (SSM / hybrid-window)."""
        return self.family in ("hybrid", "ssm")

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, dh = self.d_model, self.head_dim_
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        mlp_mult = 3 if self.gated_mlp else 2
        counts = 0
        for pattern, cnt in self.groups:
            for blk in pattern:
                if blk in ("attn", "enc", "local_attn"):
                    counts += cnt * (attn + mlp_mult * d * self.d_ff)
                elif blk == "dec_xattn":
                    counts += cnt * (2 * attn + mlp_mult * d * self.d_ff)
                elif blk == "xattn":
                    counts += cnt * (attn + mlp_mult * d * self.d_ff)
                elif blk == "attn_moe":
                    e = self.n_experts * mlp_mult * d * self.d_ff
                    sh = self.n_shared_experts * mlp_mult * d * self.d_ff
                    counts += cnt * (attn + e + sh + d * self.n_experts)
                elif blk == "attn_dense_first":
                    counts += cnt * (attn + mlp_mult * d * self.dense_d_ff)
                elif blk == "rglru":
                    w = self.lru_width or d
                    counts += cnt * (2 * d * w + 2 * w * w + w * d
                                     + mlp_mult * d * self.d_ff)
                elif blk == "mlstm":
                    di = int(d * self.proj_factor)
                    counts += cnt * (2 * d * di + 3 * di * di + di * d)
                elif blk == "slstm":
                    counts += cnt * (8 * d * d + 3 * d * int(d * 4 / 3))
                else:
                    raise ValueError(blk)
        if self.n_enc_layers:
            counts += self.n_enc_layers * (attn + mlp_mult * d * self.d_ff)
        if self.n_img_tokens:
            counts += d * d           # img_proj
        embed = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return counts + embed

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.n_params()
        full = self.n_params()
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        moe_layers = sum(cnt * pattern.count("attn_moe")
                         for pattern, cnt in self.groups)
        inactive = moe_layers * (self.n_experts - self.top_k) * mlp_mult * d * self.d_ff
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = {}
        scale["d_model"] = 64
        scale["n_heads"] = 4
        scale["n_kv_heads"] = min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1
        scale["head_dim"] = 16
        scale["d_ff"] = 128 if self.d_ff else 0
        scale["vocab_size"] = 512
        scale["groups"] = tuple((pat, min(cnt, 2)) for pat, cnt in self.groups)
        scale["n_layers"] = sum(len(p) * c for p, c in scale["groups"])
        if self.n_experts:
            scale["n_experts"] = 8
            scale["top_k"] = min(self.top_k, 2)
            scale["dense_d_ff"] = 128
        if self.window:
            scale["window"] = 32
        if self.lru_width:
            scale["lru_width"] = 64
        if self.n_enc_layers:
            scale["n_enc_layers"] = 2
            scale["enc_context"] = 16
        if self.n_img_tokens:
            scale["n_img_tokens"] = 8
        scale["loss_chunk"] = 64
        scale["remat"] = False
        return dataclasses.replace(self, **scale)


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs.archs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs.archs  # noqa: F401
    return tuple(sorted(_REGISTRY))
