"""LM assembly: decoder-only, encoder-decoder (whisper), the VLM's
interleaved cross-attention, MoE, hybrid (RG-LRU and local attention) and
recurrent (xLSTM) stacks.

The port of ``repro.models.transformer``. A model is a sequence of
*groups*; each group is (pattern, count) where the pattern is a tuple of
block types. The JAX package stacks a group's parameters over count and
runs them with ``lax.scan``; here each layer is its own module, a group is
an ``nn.ModuleList`` of ``count`` slots, each slot an ``nn.ModuleList`` of
the pattern's blocks, and a Python loop runs them. Parameter names follow
the JAX tree's paths: the JAX leaf ``groups[gi][p][...]`` stacked over
count is the port's ``groups.{gi}.{c}.{p}....`` of layer c
(``convert.lm_params_from_numpy`` maps one to the other).

Block interface (see ``BLOCKS``), each block a module holding its config:
    reset(key)                           draws the parameters as ``init``
    seq(x, ctx)                -> (x, aux_loss)          # no cache
    prefill(x, ctx, cache)     -> (x, aux, cache)
    step(x_t, cache, pos, ctx) -> (x_t, cache)
and ``block_cache_init(btype, cfg, batch, max_len, device)``.

ctx carries positions and the cross-attention context (encoder output or
image patch embeddings; both stubs feed precomputed embeddings).

Block types: ``attn``, ``attn_dense_first``, ``enc`` and ``local_attn``
(one class with ``causal``, ``window_attr`` and ``d_ff_attr``), ``xattn``,
``dec_xattn``, ``attn_moe`` (self-attention and the MoE FFN of
``models/moe.py``, its aux loss returned from ``seq`` and ``prefill``),
``rglru`` (``models/rglru.py``), ``mlstm`` and ``slstm``
(``models/xlstm.py``). A recurrent block's cache is a dict of its state,
whose shapes do not depend on ``max_len``.

Caches are written in place (the decode loop owns them) and returned.
Under autograd with ``cfg.remat`` (the default) each layer's forward runs
again in the backward pass (``_group_seq``), so training keeps one tensor
a layer (``remat_policy="full"``), or that and each attention block's
output (``"save_attn_out"``); inference keeps no activations.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
from repro_torch.models import attention as attn
from repro_torch.models import common, moe, rglru, xlstm
from repro_torch.train import sketched_dense as sd


def _cdtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _pdtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _sdtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.attn_scores_dtype == "bfloat16" \
        else torch.float32


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def constrain_act(cfg: ArchConfig, x, spec):
    """Optional activation sharding constraint (keeps the batch axis
    sharded through recurrent loops where DTensor would otherwise
    replicate it): ``x`` redistributed to ``spec`` (a tuple of mesh axis
    names or None a dim; names the mesh lacks read as None) on the mesh
    registered in ``dist.meshctx``. A no-op unless
    ``cfg.constrain_activations``, a mesh is registered and ``x`` is a
    DTensor."""
    if not cfg.constrain_activations:
        return x
    from repro_torch.dist import meshctx
    mesh = meshctx.get_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist import sharding
    resolved = tuple(s if (s is None or s in mesh.mesh_dim_names) else None
                     for s in spec)
    return x.redistribute(mesh, sharding.placements(mesh, resolved))


@torch.library.custom_op("repro_torch::attn_out", mutates_args=())
def attn_out(o: torch.Tensor) -> torch.Tensor:
    """A copy of ``o``: the tag of an attention block's output, which the
    ``save_attn_out`` remat policy keeps (``checkpoint_name(o,
    "attn_out")`` in the JAX package)."""
    return o.clone()


@attn_out.register_fake
def _(o):
    return torch.empty_like(o)


attn_out.register_autograd(lambda ctx, g: g)


def _save_attn_out(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``save_attn_out``: keep the
    tagged attention outputs, recompute everything else."""
    if op is torch.ops.repro_torch.attn_out.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _tag_attn_out(cfg, o):
    """``o`` tagged for ``save_attn_out`` when that policy is remat's
    under autograd, else ``o`` itself."""
    if (cfg.remat and cfg.remat_policy == "save_attn_out"
            and torch.is_grad_enabled()):
        return attn_out(o)
    return o


def _mlp_branch(cfg, norm, mlp, x):
    """The pre-norm MLP branch of a residual block, in the compute dtype."""
    h = common.norm_apply(cfg.norm, norm, x).to(_cdtype(cfg))
    return common.mlp_apply(mlp, h, cfg.act, _cdtype(cfg))


# ===========================================================================
# Block implementations
# ===========================================================================

class AttnBlock(nn.Module):
    """Pre-norm self-attention + MLP. Variants: causal/bidirectional/windowed,
    dense-MLP-size override (MoE stacks' first dense layer)."""

    def __init__(self, cfg: ArchConfig, *, causal=True, window_attr=None,
                 d_ff_attr="d_ff", device="cuda"):
        super().__init__()
        self._init_attention(cfg, causal, window_attr, device)
        d_ff = getattr(cfg, d_ff_attr) or cfg.d_ff
        pd = _pdtype(cfg)
        self.mlp = common.MLP(cfg.d_model, d_ff, gated=cfg.gated_mlp, dtype=pd,
                              bias=cfg.attn_bias, device=device)
        if cfg.sketched_mlp:
            # SMP-PCA gradient taps on the (flop-dominant) MLP matmuls: the
            # backward pass emits one-pass (X, dY) sketches instead of dW
            tk = sd.TapConfig().sketch_k
            self.mlp.up.taps = nn.ParameterDict(
                sd.tap_init(cfg.d_model, d_ff, tk, device=device))
            self.mlp.down.taps = nn.ParameterDict(
                sd.tap_init(d_ff, cfg.d_model, tk, device=device))

    def _init_attention(self, cfg, causal, window_attr, device):
        """``norm1``, ``attn`` and ``norm2``: what every self-attention
        block holds beside its FFN."""
        self.cfg = cfg
        self.causal = causal
        self.window = getattr(cfg, window_attr) if window_attr else None
        self.norm1 = common.norm_init(cfg.norm, cfg.d_model, device)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype=_pdtype(cfg),
                                   bias=cfg.attn_bias, device=device)
        self.norm2 = common.norm_init(cfg.norm, cfg.d_model, device)

    def reset(self, key: torch.Tensor) -> None:
        k1, k2, _, _ = prng.split(key, 4)
        self.attn.reset(k1)
        self.mlp.reset(k2)

    def _attend(self, x, ctx, cache=None, pos=None, build_cache=False):
        cfg = self.cfg
        cd = _cdtype(cfg)
        h = common.norm_apply(cfg.norm, self.norm1, x)
        q, k, v = attn.qkv_project(self.attn, h.to(cd), cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim_,
                                   ctx["positions"], cfg.rope_theta, cd)
        if cache is not None and not build_cache:        # decode
            cache = attn.cache_update(cache, k, v, pos,
                                      ring=self.window is not None)
            o = attn.decode_attention(q, cache, pos, window=self.window)
        else:
            o = attn.attention(q, k, v, causal=self.causal, window=self.window,
                               scores_dtype=_sdtype(cfg))
        B, S = x.shape[:2]
        o = o.reshape(B, S, cfg.n_heads * cfg.head_dim_)
        o = common.dense_apply(self.attn.wo, o.to(cd), cd)
        if build_cache:
            # write the prompt's KV into the preallocated cache at offset 0;
            # a ring (window) cache keeps the last `window` tokens
            L = cache["k"].shape[1]
            kk, vv = (k[:, -L:], v[:, -L:]) if (self.window and S > L) \
                else (k, v)
            cache["k"][:, :kk.shape[1]] = kk.to(cache["k"].dtype)
            cache["v"][:, :vv.shape[1]] = vv.to(cache["v"].dtype)
        return o, cache

    def _mlp(self, x):
        return _mlp_branch(self.cfg, self.norm2, self.mlp, x)

    def seq(self, x, ctx):
        cfg = self.cfg
        o, _ = self._attend(x, ctx)
        x = x + _tag_attn_out(cfg, o)
        if cfg.sketched_mlp and hasattr(self.mlp.up, "taps"):
            h = common.norm_apply(cfg.norm, self.norm2, x).to(_cdtype(cfg))
            return x + _sketched_mlp_apply(self.mlp, h, cfg, ctx), _zero(x.device)
        return x + self._mlp(x), _zero(x.device)

    def prefill(self, x, ctx, cache):
        o, cache = self._attend(x, ctx, cache=cache, build_cache=True)
        x = x + o
        return x + self._mlp(x), _zero(x.device), cache

    def step(self, x, cache, pos, ctx):
        o, cache = self._attend(x, ctx, cache=cache, pos=pos)
        x = x + o
        return x + self._mlp(x), cache


class MoEBlock(AttnBlock):
    """Self-attention + MoE FFN. Its init splits the key in 2 (attention,
    experts), not in 4 as ``AttnBlock``'s does."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        nn.Module.__init__(self)
        self._init_attention(cfg, True, None, device)
        self.moe = moe.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts,
                           n_shared=cfg.n_shared_experts, gated=cfg.gated_mlp,
                           dtype=_pdtype(cfg), device=device)

    def reset(self, key: torch.Tensor) -> None:
        k1, k2 = prng.split(key)
        self.attn.reset(k1)
        self.moe.reset(k2)

    def _ffn(self, x):
        cfg = self.cfg
        h = common.norm_apply(cfg.norm, self.norm2, x)
        out, aux = moe.moe_apply(self.moe, h, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 act=cfg.act, compute_dtype=_cdtype(cfg))
        return x + out, aux

    def seq(self, x, ctx):
        o, _ = self._attend(x, ctx)
        return self._ffn(x + o)

    def prefill(self, x, ctx, cache):
        o, cache = self._attend(x, ctx, cache=cache, build_cache=True)
        x, aux = self._ffn(x + o)
        return x, aux, cache

    def step(self, x, cache, pos, ctx):
        o, cache = self._attend(x, ctx, cache=cache, pos=pos)
        x, _ = self._ffn(x + o)
        return x, cache


class CrossBlock(nn.Module):
    """Gated cross-attention + MLP (VLM interleaved layers). The KV side is a
    static context (image patches); its projections are cached at prefill.
    Both gates start at 0, so at init the block is the identity."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        pd = _pdtype(cfg)
        self.norm1 = common.norm_init(cfg.norm, cfg.d_model, device)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype=pd, device=device)
        self.gate_attn = nn.Parameter(torch.zeros((), device=device))
        self.norm2 = common.norm_init(cfg.norm, cfg.d_model, device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                              dtype=pd, device=device)
        self.gate_mlp = nn.Parameter(torch.zeros((), device=device))

    def reset(self, key: torch.Tensor) -> None:
        k1, k2 = prng.split(key)
        self.attn.reset(k1)
        self.mlp.reset(k2)
        with torch.no_grad():
            self.gate_attn.zero_()
            self.gate_mlp.zero_()

    def _cross_kv(self, ctx_seq):
        cfg = self.cfg
        cd = _cdtype(cfg)
        B, L, _ = ctx_seq.shape
        k = sharding.fit_heads(
            common.dense_apply(self.attn.wk, ctx_seq.to(cd), cd),
            cfg.n_kv_heads).reshape(B, L, cfg.n_kv_heads, cfg.head_dim_)
        v = sharding.fit_heads(
            common.dense_apply(self.attn.wv, ctx_seq.to(cd), cd),
            cfg.n_kv_heads).reshape(B, L, cfg.n_kv_heads, cfg.head_dim_)
        return k.to(cd), v.to(cd)

    def _cross(self, x, k, v, decode=False):
        cfg = self.cfg
        cd = _cdtype(cfg)
        B, S, _ = x.shape
        h = common.norm_apply(cfg.norm, self.norm1, x)
        q = sharding.fit_heads(
            common.dense_apply(self.attn.wq, h.to(cd), cd),
            cfg.n_heads).reshape(B, S, cfg.n_heads, cfg.head_dim_)
        o = attn.cross_attention(q, k, v, decode=decode)
        o = o.reshape(B, S, cfg.n_heads * cfg.head_dim_)
        o = common.dense_apply(self.attn.wo, o.to(cd), cd)
        return torch.tanh(self.gate_attn) * o

    def _mlp(self, x):
        cfg = self.cfg
        h = common.mlp_apply(
            self.mlp,
            common.norm_apply(cfg.norm, self.norm2, x).to(_cdtype(cfg)),
            cfg.act, _cdtype(cfg))
        return torch.tanh(self.gate_mlp) * h

    def seq(self, x, ctx):
        k, v = self._cross_kv(ctx["xattn_ctx"])
        x = x + self._cross(x, k, v)
        return x + self._mlp(x), _zero(x.device)

    def prefill(self, x, ctx, cache):
        k, v = self._cross_kv(ctx["xattn_ctx"])
        x = x + self._cross(x, k, v)
        x = x + self._mlp(x)
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        return x, _zero(x.device), cache

    def step(self, x, cache, pos, ctx):
        x = x + self._cross(x, cache["k"], cache["v"], decode=True)
        return x + self._mlp(x), cache


class DecXAttnBlock(AttnBlock):
    """Whisper decoder layer: causal self-attn + cross-attn(enc) + MLP."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__(cfg, causal=True, device=device)
        self.normx = common.norm_init(cfg.norm, cfg.d_model, device)
        self.xattn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim_, dtype=_pdtype(cfg),
                                    bias=cfg.attn_bias, device=device)

    def reset(self, key: torch.Tensor) -> None:
        super().reset(key)
        self.xattn.reset(prng.fold_in(key, 99))

    def _enc_kv(self, enc):
        cfg = self.cfg
        cd = _cdtype(cfg)
        B, L, _ = enc.shape
        k = sharding.fit_heads(
            common.dense_apply(self.xattn.wk, enc.to(cd), cd),
            cfg.n_kv_heads).reshape(B, L, cfg.n_kv_heads, cfg.head_dim_)
        v = sharding.fit_heads(
            common.dense_apply(self.xattn.wv, enc.to(cd), cd),
            cfg.n_kv_heads).reshape(B, L, cfg.n_kv_heads, cfg.head_dim_)
        return k, v

    def _xattend(self, x, k, v, decode=False):
        cfg = self.cfg
        cd = _cdtype(cfg)
        B, S, _ = x.shape
        h = common.norm_apply(cfg.norm, self.normx, x)
        q = sharding.fit_heads(
            common.dense_apply(self.xattn.wq, h.to(cd), cd),
            cfg.n_heads).reshape(B, S, cfg.n_heads, cfg.head_dim_)
        o = attn.cross_attention(q, k, v, decode=decode)
        o = o.reshape(B, S, cfg.n_heads * cfg.head_dim_)
        return common.dense_apply(self.xattn.wo, o.to(cd), cd)

    def seq(self, x, ctx):
        o, _ = self._attend(x, ctx)
        x = x + o
        k, v = self._enc_kv(ctx["xattn_ctx"])
        x = x + self._xattend(x, k, v)
        return x + self._mlp(x), _zero(x.device)

    def prefill(self, x, ctx, cache):
        o, self_cache = self._attend(x, ctx, cache=cache["self"],
                                     build_cache=True)
        x = x + o
        k, v = self._enc_kv(ctx["xattn_ctx"])
        x = x + self._xattend(x, k, v)
        x = x + self._mlp(x)
        cache["cross"]["k"].copy_(k)
        cache["cross"]["v"].copy_(v)
        return x, _zero(x.device), {"self": self_cache, "cross": cache["cross"]}

    def step(self, x, cache, pos, ctx):
        o, self_cache = self._attend(x, ctx, cache=cache["self"], pos=pos)
        x = x + o
        x = x + self._xattend(x, cache["cross"]["k"], cache["cross"]["v"],
                              decode=True)
        x = x + self._mlp(x)
        return x, {"self": self_cache, "cross": cache["cross"]}


class RGLRUBlock(nn.Module):
    """RecurrentGemma block: RG-LRU mixer + MLP, both pre-norm residual."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        pd = _pdtype(cfg)
        self.norm1 = common.norm_init(cfg.norm, cfg.d_model, device)
        self.lru = rglru.RGLRU(cfg.d_model, cfg.lru_width or cfg.d_model,
                               dtype=pd, device=device)
        self.norm2 = common.norm_init(cfg.norm, cfg.d_model, device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                              dtype=pd, device=device)

    def reset(self, key: torch.Tensor) -> None:
        k1, k2 = prng.split(key)
        self.lru.reset(k1)
        self.mlp.reset(k2)

    def _mlp(self, x):
        return _mlp_branch(self.cfg, self.norm2, self.mlp, x)

    def seq(self, x, ctx):
        h = common.norm_apply(self.cfg.norm, self.norm1, x)
        x = x + rglru.rglru_block_seq(self.lru, h, _cdtype(self.cfg))
        return x + self._mlp(x), _zero(x.device)

    def prefill(self, x, ctx, cache):
        """The sequence in its parallel form; the final h and the conv
        state (in the cache's dtype) handed to decode."""
        cd = _cdtype(self.cfg)
        h = common.norm_apply(self.cfg.norm, self.norm1, x)
        y, h_final, gate, conv_state = rglru.block_front(self.lru, h, cd)
        x = x + common.dense_apply(self.lru.w_out, (y * gate).to(cd), cd)
        cache["h"].copy_(h_final)
        cache["conv"].copy_(conv_state)
        return x + self._mlp(x), _zero(x.device), cache

    def step(self, x, cache, pos, ctx):
        h = common.norm_apply(self.cfg.norm, self.norm1, x)
        o, cache = rglru.rglru_block_step(self.lru, h, cache,
                                          _cdtype(self.cfg))
        x = x + o
        return x + self._mlp(x), cache


class MLSTMBlock(nn.Module):
    """Pre-norm residual mLSTM; its init draws from the unsplit key."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.norm = common.norm_init(cfg.norm, cfg.d_model, device)
        self.core = xlstm.MLSTM(cfg.d_model, cfg.n_heads,
                                proj_factor=cfg.proj_factor,
                                dtype=_pdtype(cfg), device=device)

    def reset(self, key: torch.Tensor) -> None:
        self.core.reset(key)

    def seq(self, x, ctx):
        h = common.norm_apply(self.cfg.norm, self.norm, x)
        return x + xlstm.mlstm_block_seq(self.core, h, self.cfg.n_heads,
                                         _cdtype(self.cfg)), _zero(x.device)

    def prefill(self, x, ctx, cache):
        h = common.norm_apply(self.cfg.norm, self.norm, x)
        o, state = xlstm.mlstm_block_seq(self.core, h, self.cfg.n_heads,
                                         _cdtype(self.cfg), return_state=True)
        for name, t in state.items():
            cache[name].copy_(t)
        return x + o, _zero(x.device), cache

    def step(self, x, cache, pos, ctx):
        h = common.norm_apply(self.cfg.norm, self.norm, x)
        o, cache = xlstm.mlstm_block_step(self.core, h, cache,
                                          self.cfg.n_heads, _cdtype(self.cfg))
        return x + o, cache


class SLSTMBlock(nn.Module):
    """Pre-norm residual sLSTM (a loop over time). With
    ``cfg.constrain_activations`` its gate buffer is held to the batch
    sharding (``constrain_act``), as in the JAX package; on one device the
    hook changes nothing."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.norm = common.norm_init(cfg.norm, cfg.d_model, device)
        self.core = xlstm.SLSTM(cfg.d_model, cfg.n_heads, dtype=_pdtype(cfg),
                                device=device)

    def reset(self, key: torch.Tensor) -> None:
        self.core.reset(key)

    def seq(self, x, ctx):
        cfg = self.cfg
        h = common.norm_apply(cfg.norm, self.norm, x)
        cons = (lambda t, spec: constrain_act(cfg, t, spec)) \
            if cfg.constrain_activations else None
        return x + xlstm.slstm_block_seq(self.core, h, _cdtype(cfg),
                                         constrain=cons), _zero(x.device)

    def prefill(self, x, ctx, cache):
        h = common.norm_apply(self.cfg.norm, self.norm, x)
        o, state = xlstm.slstm_block_seq(self.core, h, _cdtype(self.cfg),
                                         return_state=True)
        for name, t in state.items():
            cache[name].copy_(t)
        return x + o, _zero(x.device), cache

    def step(self, x, cache, pos, ctx):
        h = common.norm_apply(self.cfg.norm, self.norm, x)
        o, cache = xlstm.slstm_block_step(self.core, h, cache,
                                          _cdtype(self.cfg))
        return x + o, cache


BLOCKS = {
    "attn": lambda cfg, device: AttnBlock(cfg, causal=True, device=device),
    "attn_dense_first": lambda cfg, device: AttnBlock(
        cfg, causal=True, d_ff_attr="dense_d_ff", device=device),
    "enc": lambda cfg, device: AttnBlock(cfg, causal=False, device=device),
    "local_attn": lambda cfg, device: AttnBlock(
        cfg, causal=True, window_attr="window", device=device),
    "attn_moe": MoEBlock,
    "xattn": CrossBlock,
    "dec_xattn": DecXAttnBlock,
    "rglru": RGLRUBlock,
    "mlstm": MLSTMBlock,
    "slstm": SLSTMBlock,
}


def make_block(btype: str, cfg: ArchConfig, device="cuda") -> nn.Module:
    return BLOCKS[btype](cfg, device)


def block_cache_init(btype: str, cfg: ArchConfig, batch: int, max_len: int,
                     device="cuda"):
    """The zero cache of one block: a self-attention KV cache of max_len
    rows (a window's rows for ``local_attn``), a cross-attention cache of
    the context's length, or both for ``dec_xattn``, bf16 under bf16
    compute; a recurrent block's state (``rglru``: {h, conv}, ``mlstm``:
    {C, n, m, conv}, ``slstm``: {h, c, n, m})."""
    if btype == "rglru":
        return rglru.rglru_block_cache_init(batch, cfg.lru_width or cfg.d_model,
                                            _cdtype(cfg), device)
    if btype == "mlstm":
        di = int(cfg.d_model * cfg.proj_factor)
        return xlstm.mlstm_cache_init(batch, cfg.n_heads, di // cfg.n_heads,
                                      di, device)
    if btype == "slstm":
        return xlstm.slstm_cache_init(batch, cfg.d_model, device)
    kw = dict(dtype=_cdtype(cfg), device=device)
    nkv, dh = cfg.n_kv_heads, cfg.head_dim_
    if btype == "xattn":
        return attn.init_kv_cache(batch, cfg.n_img_tokens or cfg.enc_context,
                                  nkv, dh, **kw)
    if btype == "dec_xattn":
        return {"self": attn.init_kv_cache(batch, max_len, nkv, dh, **kw),
                "cross": attn.init_kv_cache(batch, cfg.enc_context, nkv, dh,
                                            **kw)}
    window = cfg.window if btype == "local_attn" else None
    return attn.init_kv_cache(batch, min(window or max_len, max_len), nkv, dh,
                              **kw)


def _sketched_mlp_apply(p: common.MLP, h, cfg, ctx):
    """MLP with gradient-tap dense layers on up/down (gate stays plain:
    its grad shares X with up and adds little information). The tapped
    layers carry no bias, as in the JAX package."""
    cd = _cdtype(cfg)
    key = ctx.get("sketch_key")
    if key is None:
        key = prng.PRNGKey(0, device=h.device)
    tk = sd.TapConfig().sketch_k
    up = sd.sketched_dense(p.up.w, dict(p.up.taps), h.to(cd), key, tk, 2048)
    if p.gate is not None:
        g = common.dense_apply(p.gate, h, cd)
        hidden = common.ACTIVATIONS[cfg.act](g) * up
    else:
        hidden = common.ACTIVATIONS[cfg.act](up)
    return sd.sketched_dense(p.down.w, dict(p.down.taps), hidden.to(cd),
                             prng.fold_in(key, 1), tk, 2048)


# ===========================================================================
# Groups: one module a layer, a Python loop over them
# ===========================================================================

def _group(pattern, count, cfg, device) -> nn.ModuleList:
    return nn.ModuleList([
        nn.ModuleList([make_block(b, cfg, device) for b in pattern])
        for _ in range(count)])


def _group_init(group: nn.ModuleList, key: torch.Tensor) -> None:
    """``jax.vmap(slot)(split(key, count))``: layer c's slot draws from
    ``split(key, count)[c]``, split once more over the pattern."""
    keys = prng.split(key, len(group))
    for slot, slot_key in zip(group, keys):
        for blk, k in zip(slot, prng.split(slot_key, len(slot))):
            blk.reset(k)


def _slot_seq(slot, x, ctx):
    aux = _zero(x.device)
    for blk in slot:
        x, a = blk.seq(x, ctx)
        aux = aux + a
    return x, aux


def _group_seq(group, cfg, x, ctx):
    """The group's layers in order. Under autograd with ``cfg.remat`` each
    slot (one scan step of the JAX package) runs under a non-reentrant
    ``checkpoint``, the counterpart of ``jax.checkpoint(body,
    policy=nothing_saveable)``: only the slot's input is kept, and its
    forward runs again, under grad, in the backward pass. (The reentrant
    form would run the first forward under ``no_grad``, which takes the
    flash route, and the recompute under grad, which takes the plain one.)
    ``remat_policy="save_attn_out"`` (``save_only_these_names("attn_out")``
    in the JAX package) keeps each attention block's tagged output besides:
    a selective checkpoint whose policy saves the ``attn_out`` op's output
    and recomputes every other op."""
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy not in ("full", "save_attn_out"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "('full' or 'save_attn_out')")
    kw = {}
    if remat and cfg.remat_policy == "save_attn_out":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_attn_out)
    aux = _zero(x.device)
    for slot in group:
        if remat:
            x, a = checkpoint(_slot_seq, slot, x, ctx, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        else:
            x, a = _slot_seq(slot, x, ctx)
        aux = aux + a
    return x, aux


def _group_prefill(group, caches, x, ctx):
    new = []
    for slot, slot_caches in zip(group, caches):
        out = []
        for blk, c in zip(slot, slot_caches):
            x, _, c = blk.prefill(x, ctx, c)
            out.append(c)
        new.append(tuple(out))
    return x, new


def _group_cache_init(pattern, count, cfg, batch, max_len, device):
    return [tuple(block_cache_init(b, cfg, batch, max_len, device)
                  for b in pattern) for _ in range(count)]


def _group_step(group, caches, x, pos, ctx):
    new = []
    for slot, slot_caches in zip(group, caches):
        out = []
        for blk, c in zip(slot, slot_caches):
            x, c = blk.step(x, c, pos, ctx)
            out.append(c)
        new.append(tuple(out))
    return x, new


# ===========================================================================
# Whole-model init / forward / loss / prefill / decode
# ===========================================================================

class Encoder(nn.Module):
    """Whisper's encoder: one group of ``enc`` blocks and a final norm."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.groups = nn.ModuleList([_group(("enc",), cfg.n_enc_layers, cfg,
                                            device)])
        self.final_norm = common.norm_init(cfg.norm, cfg.d_model, device)


class LM(nn.Module):
    """The parameters of one model, as the JAX tree names them: ``embed``,
    ``final_norm``, ``groups``, and ``head``, ``enc`` and ``img_proj`` where
    the config has them."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        pd = _pdtype(cfg)
        self.embed = common.Embedding(cfg.vocab_padded, cfg.d_model, pd,
                                      device)
        self.final_norm = common.norm_init(cfg.norm, cfg.d_model, device)
        self.groups = nn.ModuleList([_group(pattern, count, cfg, device)
                                     for pattern, count in cfg.groups])
        self.head = (None if cfg.tie_embeddings else
                     common.Dense(cfg.d_model, cfg.vocab_padded, dtype=pd,
                                  device=device))
        self.enc = Encoder(cfg, device) if cfg.is_encdec else None
        self.img_proj = (common.Dense(cfg.d_model, cfg.d_model, dtype=pd,
                                      device=device)
                         if cfg.n_img_tokens else None)


def init_params(key: torch.Tensor, cfg: ArchConfig, device="cuda") -> LM:
    """The JAX package's ``init_params`` key tree: ``split(key, 8)``; the
    embedding from part 0, group gi from ``fold_in(part 1, gi)``, the head
    from part 2, the encoder from part 3, the image projection from part
    4. Drawn on ``device`` (the card by default)."""
    params = LM(cfg, device)
    ks = prng.split(key.to(device), 8)
    params.embed.reset(ks[0])
    for gi, group in enumerate(params.groups):
        _group_init(group, prng.fold_in(ks[1], gi))
    if params.head is not None:
        params.head.reset(ks[2])
    if params.enc is not None:
        _group_init(params.enc.groups[0], ks[3])
    if params.img_proj is not None:
        params.img_proj.reset(ks[4])
    return params


def _encode(params: LM, cfg, enc_input):
    """Whisper encoder over stubbed frame embeddings (B, enc_context, d)."""
    S = enc_input.shape[1]
    dev = enc_input.device
    x = enc_input.float() + common.sinusoidal_positions(S, cfg.d_model, dev)
    ctx = {"positions": torch.arange(S, device=dev), "xattn_ctx": None}
    x, _ = _group_seq(params.enc.groups[0], cfg, x, ctx)
    return common.norm_apply(cfg.norm, params.enc.final_norm, x)


def _xattn_context(params: LM, cfg, aux_inputs):
    if cfg.is_encdec:
        return _encode(params, cfg, aux_inputs["enc_frames"])
    if cfg.n_img_tokens:
        return common.dense_apply(params.img_proj, aux_inputs["img_embeds"],
                                  _cdtype(cfg))
    return None


def _backbone(params: LM, cfg, x, ctx, mode="seq", caches=None, pos=None):
    aux_total = _zero(x.device)
    new_caches = []
    for gi, group in enumerate(params.groups):
        if mode == "seq":
            x, aux = _group_seq(group, cfg, x, ctx)
            aux_total = aux_total + aux
        elif mode == "prefill":
            x, cache = _group_prefill(group, caches[gi], x, ctx)
            new_caches.append(cache)
        elif mode == "step":
            x, cache = _group_step(group, caches[gi], x, pos, ctx)
            new_caches.append(cache)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    x = common.norm_apply(cfg.norm, params.final_norm, x)
    return x, aux_total, new_caches


def _embed_tokens(params: LM, cfg, tokens, positions=None):
    x = common.embed_apply(params.embed, tokens).float()
    if cfg.rope_theta is None:   # absolute sinusoidal positions
        S = tokens.shape[1]
        if positions is None:
            x = x + common.sinusoidal_positions(S, cfg.d_model, x.device)
        else:
            # decode: the single position's embedding, computed directly
            pos = positions.reshape(-1)[:1].float()
            x = x + common.sinusoidal_at(pos, cfg.d_model)
    return x


def _logits(params: LM, cfg, x):
    if cfg.tie_embeddings:
        logits = common.unembed_apply(params.embed, x, _cdtype(cfg))
    else:
        logits = common.dense_apply(params.head, x, _cdtype(cfg))
    # mask vocab padding
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def lm_forward(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab_padded), float32: the parallel
    forward that prefill and decode must reproduce."""
    tokens = batch["tokens"]
    ctx = {"positions": torch.arange(tokens.shape[1], device=tokens.device),
           "xattn_ctx": _xattn_context(params, cfg, batch)}
    x = _embed_tokens(params, cfg, tokens)
    x, _, _ = _backbone(params, cfg, x, ctx, mode="seq")
    return _logits(params, cfg, x)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's negative log-likelihood of its label."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def lm_loss(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Mean next-token cross entropy, sequence-chunked over the (huge) vocab
    projection so peak memory is O(B * loss_chunk * vocab)."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    dev = tokens.device
    ctx = {"positions": torch.arange(S, device=dev),
           "xattn_ctx": _xattn_context(params, cfg, batch),
           "sketch_key": prng.PRNGKey(17, device=dev)}
    x = _embed_tokens(params, cfg, tokens)
    x, aux, _ = _backbone(params, cfg, x, ctx, mode="seq")

    ck = min(cfg.loss_chunk, S)
    if S % ck:
        raise ValueError(f"lm_loss: S={S} not divisible by loss_chunk {ck}")
    total = _zero(dev)
    for s0 in range(0, S, ck):
        logits = _logits(params, cfg, x[:, s0:s0 + ck])
        # per token: under DTensor each device takes its own rows, the
        # vocab whole (the gather's backward would build the chunk's
        # whole gradient on every device)
        nll = sharding.local_over(_nll, (logits, labels[:, s0:s0 + ck]),
                                  ((0, None), (0, None)), (0, None))
        total = total + torch.sum(nll)
    loss = total / (B * S)
    if cfg.n_experts:
        loss = loss + cfg.aux_loss_weight * aux
    return loss


def lm_prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               caches):
    """Forward over the prompt, writing KV into the *preallocated* caches
    (serving allocates max_len up front and prefill fills the prefix).
    Returns (last-token logits (B, 1, vocab_padded), filled caches)."""
    tokens = batch["tokens"]
    ctx = {"positions": torch.arange(tokens.shape[1], device=tokens.device),
           "xattn_ctx": _xattn_context(params, cfg, batch)}
    x = _embed_tokens(params, cfg, tokens)
    x, _, caches = _backbone(params, cfg, x, ctx, mode="prefill",
                             caches=caches)
    return _logits(params, cfg, x[:, -1:, :]), caches


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    """Per group, per layer, the tuple of its pattern's block caches."""
    return [_group_cache_init(pattern, count, cfg, batch, max_len, device)
            for pattern, count in cfg.groups]


def lm_decode_step(params: LM, cfg: ArchConfig, caches,
                   token: torch.Tensor, pos,
                   aux_inputs: Optional[Dict[str, Any]] = None):
    """One decode step. token: (B, 1) integer; pos: the current position
    (an int). Returns (logits (B, 1, vocab_padded), caches)."""
    positions = torch.tensor([int(pos)], device=token.device)
    ctx = {"positions": positions, "xattn_ctx": None}
    x = _embed_tokens(params, cfg, token, positions=positions)
    x, _, new_caches = _backbone(params, cfg, x, ctx, mode="step",
                                 caches=caches, pos=pos)
    return _logits(params, cfg, x), new_caches
