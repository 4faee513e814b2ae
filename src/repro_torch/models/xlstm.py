"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory with exponential gating).

The port of ``repro.models.xlstm``: ``mlstm_init`` and ``slstm_init``
become the ``MLSTM`` and ``SLSTM`` modules (their parameters under the JAX
tree's names) with ``reset(key)``, the rest plain functions of them, in
plain PyTorch as the reference is plain JAX.

mLSTM recurrence per head (state C: Dh x Dh, normalizer n: Dh, stabilizer m):
    f_t = exp gate (forget, log-space), i_t = exp gate (input)
    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = exp(log f_t + m_{t-1} - m_t) C_{t-1} + exp(log i_t - m_t) v_t k_t^T
    n_t = exp(log f_t + m_{t-1} - m_t) n_{t-1} + exp(log i_t - m_t) k_t
    h_t = C_t q_t / max(|n_t^T q_t|, 1)

Prefill uses the chunkwise-parallel form when S is a multiple of
``MLSTM_CHUNK`` above it (a Python loop over chunks carries (C, n, m), as
``lax.scan`` does), else the single-chunk (S, S) form; both mask in log
space with -inf and start the stabilizer at -1e30, as the reference does.

sLSTM keeps per-unit scalar state (c, n, m) and is sequential: a Python
loop over time, the state in float32. Its ``constrain`` hook holds the
gate buffer to a sharding (``transformer.constrain_act``, a DTensor
redistribution); on one device it changes nothing. The dry run's analyzer
counts one step of the loop S times (``_SLSTMTrace``) instead of tracing
S steps on ``meta`` tensors.

The bf16 defaults of the reference are kept: ``w_if`` is a float32
parameter but its product runs in ``dense_apply``'s default bf16, and so
does the sLSTM's recurrent product.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.dist import sharding
from repro_torch.models import common
from repro_torch.roofline import trace_analyzer

MLSTM_CHUNK = 256
_M0 = -1e30          # the stabilizer's start


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, d: int, n_heads: int, *, proj_factor: float = 2.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        di = int(d * proj_factor)
        kw = dict(dtype=dtype, device=device)
        self.w_up = common.Dense(d, 2 * di, **kw)          # x and gate
        self.wq = common.Dense(di, di, **kw)
        self.wk = common.Dense(di, di, **kw)
        self.wv = common.Dense(di, di, **kw)
        self.w_if = common.Dense(di, 2 * n_heads, device=device)
        self.conv_w = nn.Parameter(torch.empty(4, di, **kw))
        self.norm = common.norm_init("rmsnorm", di, device)
        self.w_down = common.Dense(di, d, **kw)

    def reset(self, key: torch.Tensor) -> None:
        """``mlstm_init``: ``split(key, 8)``, one part a leaf in order
        (``w_if`` drawn in float32 whatever the dtype)."""
        ks = prng.split(key.to(self.conv_w.device), 8)
        for layer, k in zip((self.w_up, self.wq, self.wk, self.wv,
                             self.w_if), ks[:5]):
            layer.reset(k)
        with torch.no_grad():
            self.conv_w.copy_(prng.normal(ks[5], tuple(self.conv_w.shape))
                              * 0.5)
        self.norm.reset()
        self.w_down.reset(ks[6])


def _mlstm_chunk_parallel(q, k, v, log_f, log_i):
    """Chunkwise-parallel mLSTM. q, k, v: (B, H, S, Dh); gates: (B, H, S).
    Returns (h (B, H, S, Dh), the end-of-sequence (C, n, m))."""
    B, H, S, Dh = q.shape
    L = MLSTM_CHUNK
    dev = q.device
    q, k, v = q.float(), k.float(), v.float()
    sq = math.sqrt(Dh)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    C = torch.zeros((B, H, Dh, Dh), device=dev)
    n = torch.zeros((B, H, Dh), device=dev)
    m = torch.full((B, H), _M0, device=dev)
    hs = []
    for c0 in range(0, S, L):
        qb, kb, vb = q[:, :, c0:c0 + L], k[:, :, c0:c0 + L], v[:, :, c0:c0 + L]
        fb, ib = log_f[..., c0:c0 + L], log_i[..., c0:c0 + L]
        b = torch.cumsum(fb, dim=-1)                   # log prod f_1..t
        # intra-chunk weights: for s <= t, prod_{u=s+1..t} f_u * i_s
        log_w = b[..., :, None] - b[..., None, :] + ib[..., None, :]
        log_w = torch.where(mask, log_w, -math.inf)
        # inter-chunk: exp(b_t + m_prev) applied to the carried state
        m_intra = log_w.amax(dim=-1)                   # (B, H, L)
        m_inter = b + m[..., None]
        m_t = torch.maximum(m_intra, m_inter)
        w = torch.exp(log_w - m_t[..., None])          # (B, H, L, L)
        scale_inter = torch.exp(m_inter - m_t)
        scores = (qb @ kb.transpose(-1, -2)) / sq
        h_intra = (w * scores) @ vb
        h_inter = (qb @ C) * scale_inter[..., None] / sq
        num = h_intra + h_inter
        # denominator: n_t^T q_t with the same weighting
        den_intra = ((w @ kb) * qb).sum(-1) / sq
        den_inter = (qb @ n[..., None])[..., 0] * scale_inter / sq
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_t))
        hs.append(num / den[..., None])
        # ---- carry update to the end of the chunk ----
        tot_f = b[..., -1]                             # (B, H)
        tail = ib + (tot_f[..., None] - b)
        m_end = torch.maximum(tot_f + m, tail.amax(dim=-1))
        decay_old = torch.exp(tot_f + m - m_end)
        wk_end = torch.exp(tail - m_end[..., None])    # (B, H, L)
        C = decay_old[..., None, None] * C \
            + (wk_end[..., None] * kb).transpose(-1, -2) @ vb
        n = decay_old[..., None] * n + (wk_end[..., None] * kb).sum(-2)
        m = m_end
    return torch.cat(hs, dim=2), (C, n, m)


def _mlstm_chunk_parallel_single(q, k, v, log_f, log_i):
    """Single-chunk (full-sequence) stabilized parallel form."""
    B, H, S, Dh = q.shape
    q, k, v = q.float(), k.float(), v.float()
    sq = math.sqrt(Dh)
    b = torch.cumsum(log_f, dim=-1)
    log_w = b[..., :, None] - b[..., None, :] + log_i[..., None, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    log_w = torch.where(mask, log_w, -math.inf)
    m_t = log_w.amax(dim=-1)
    w = torch.exp(log_w - m_t[..., None])
    scores = (q @ k.transpose(-1, -2)) / sq
    num = (w * scores) @ v
    den = torch.maximum(torch.abs(((w @ k) * q).sum(-1) / sq),
                        torch.exp(-m_t))
    # end-of-sequence carry (chunk_step's algebra with m_prev = -inf)
    tot_f = b[..., -1]
    tail = log_i + (tot_f[..., None] - b)
    m_end = tail.amax(dim=-1)
    wk_end = torch.exp(tail - m_end[..., None])
    C = (wk_end[..., None] * k).transpose(-1, -2) @ v
    n = (wk_end[..., None] * k).sum(-2)
    return num / den[..., None], (C, n, m_end)


def _conv4(conv_w, xp, S):
    return sum(xp[:, i:i + S, :] * conv_w[i][None, None, :].float()
               for i in range(4))


def mlstm_inputs(p: MLSTM, x: torch.Tensor, n_heads: int,
                 compute_dtype=torch.bfloat16):
    """The block's front over a sequence x (B, S, d): q, k, v (B, H, S,
    Dh), log f and log i (B, H, S), the output gate (B, S, di) and the
    conv input padded with its 3-row zero state, (B, S + 3, di)."""
    B, S, d = x.shape
    up = common.dense_apply(p.w_up, x, compute_dtype)
    xi, gate = torch.chunk(up, 2, dim=-1)               # (B, S, di)
    di = xi.shape[-1]
    dh = di // n_heads
    # causal conv front (as in the paper's block)
    state = torch.zeros((B, 3, di), dtype=xi.dtype, device=x.device)
    xp = torch.cat([state, xi.float()], dim=1)
    xc = F.silu(_conv4(p.conv_w, xp, S))
    q = sharding.fit_heads(
        common.dense_apply(p.wq, xc, compute_dtype),
        n_heads).reshape(B, S, n_heads, dh)
    k = sharding.fit_heads(
        common.dense_apply(p.wk, xc, compute_dtype),
        n_heads).reshape(B, S, n_heads, dh)
    v = sharding.fit_heads(
        common.dense_apply(p.wv, xi, compute_dtype),
        n_heads).reshape(B, S, n_heads, dh)
    if_gates = common.dense_apply(p.w_if, xc)           # (B, S, 2H) float32
    log_i, log_f = torch.chunk(if_gates, 2, dim=-1)
    log_f = F.logsigmoid(log_f)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    return q, k, v, log_f.transpose(1, 2), log_i.transpose(1, 2), gate, xp


def mlstm_block_seq(p: MLSTM, x: torch.Tensor, n_heads: int,
                    compute_dtype=torch.bfloat16, return_state: bool = False):
    """Full mLSTM block over a sequence. x: (B, S, d).

    return_state=True additionally returns the decode cache holding the
    end-of-sequence (C, n, m) carry and conv state (exact prefill handoff)."""
    B, S, d = x.shape
    q, k, v, log_f, log_i, gate, xp = mlstm_inputs(p, x, n_heads,
                                                   compute_dtype)
    core = _mlstm_chunk_parallel if S % MLSTM_CHUNK == 0 and \
        S > MLSTM_CHUNK else _mlstm_chunk_parallel_single
    # per (batch, head): under DTensor each device runs its shard's chunks
    bh = (0, 1)
    h, C, n, m = sharding.local_over(
        lambda *a: (lambda hh, st: (hh,) + st)(*core(*a)),
        (q, k, v, log_f, log_i), (bh,) * 5, (bh,) * 4)
    h = h.transpose(1, 2).reshape(B, S, gate.shape[-1])
    h = common.rmsnorm_apply(p.norm, h)
    out = h * F.silu(gate.float())
    out = common.dense_apply(p.w_down, out.to(compute_dtype), compute_dtype)
    if return_state:
        return out, {"C": C, "n": n, "m": m, "conv": xp[:, -3:]}
    return out


def mlstm_cache_init(batch: int, n_heads: int, head_dim: int, di: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim), **kw),
            "n": torch.zeros((batch, n_heads, head_dim), **kw),
            "m": torch.full((batch, n_heads), _M0, **kw),
            "conv": torch.zeros((batch, 3, di), **kw)}


def mlstm_block_step(p: MLSTM, x_t: torch.Tensor, cache, n_heads: int,
                     compute_dtype=torch.bfloat16):
    """One decode step. x_t: (B, 1, d). Writes the new state into
    ``cache`` and returns (out, cache)."""
    B = x_t.shape[0]
    up = common.dense_apply(p.w_up, x_t, compute_dtype)
    xi, gate = torch.chunk(up, 2, dim=-1)
    di = xi.shape[-1]
    dh = di // n_heads
    xp = torch.cat([cache["conv"], xi.float()], dim=1)
    xc = F.silu(_conv4(p.conv_w, xp, 1))
    q = sharding.fit_heads(
        common.dense_apply(p.wq, xc, compute_dtype),
        n_heads).reshape(B, n_heads, dh)
    k = sharding.fit_heads(
        common.dense_apply(p.wk, xc, compute_dtype),
        n_heads).reshape(B, n_heads, dh)
    v = sharding.fit_heads(
        common.dense_apply(p.wv, xi, compute_dtype),
        n_heads).reshape(B, n_heads, dh)
    if_g = common.dense_apply(p.w_if, xc)[:, 0]         # (B, 2H)
    log_i, log_f = torch.chunk(if_g, 2, dim=-1)
    log_f = F.logsigmoid(log_f)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(log_f + m, log_i)
    df = torch.exp(log_f + m - m_new)
    di_ = torch.exp(log_i - m_new)
    q, k, v = q.float(), k.float(), v.float()
    C_new = df[..., None, None] * C + di_[..., None, None] \
        * (k[..., :, None] * v[..., None, :])
    n_new = df[..., None] * n + di_[..., None] * k
    num = (q[..., None, :] @ C_new)[..., 0, :] / math.sqrt(dh)
    den = torch.maximum(torch.abs((n_new * q).sum(-1) / math.sqrt(dh)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, di)
    h = common.rmsnorm_apply(p.norm, h)
    out = h * F.silu(gate.float())
    out = common.dense_apply(p.w_down, out.to(compute_dtype), compute_dtype)
    for name, t in (("C", C_new), ("n", n_new), ("m", m_new),
                    ("conv", xp[:, -3:])):
        cache[name].copy_(t)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    def __init__(self, d: int, n_heads: int, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_gates = common.Dense(d, 4 * d, **kw)       # z i f o
        self.r_gates = common.Dense(d, 4 * d, **kw)       # recurrent
        self.norm = common.norm_init("rmsnorm", d, device)
        self.w_ff = common.MLP(d, int(d * 4 / 3), gated=True, **kw)

    def reset(self, key: torch.Tensor) -> None:
        """``slstm_init``: ``split(key, 3)``: the input gates, the
        recurrent gates, the feed-forward MLP."""
        ks = prng.split(key.to(self.norm.scale.device), 3)
        self.w_gates.reset(ks[0])
        self.r_gates.reset(ks[1])
        self.norm.reset()
        self.w_ff.reset(ks[2])


def _slstm_cell(p: SLSTM, x_gates, h_prev, state):
    """x_gates: (B, 4d) precomputed input projections; state: (c, n, m)."""
    c, n, m = state
    r = common.dense_apply(p.r_gates, h_prev)             # (B, 4d), bf16
    z, i, f, o = torch.chunk(x_gates + r, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(log_f + m - m_new)
    c_new = fg * c + ig * z
    n_new = fg * n + ig
    h = o * c_new / torch.clamp(n_new, min=1.0)
    return h, (c_new, n_new, m_new)


def slstm_cache_init(batch: int, d: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    kw = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), **kw),
            "c": torch.zeros((batch, d), **kw),
            "n": torch.zeros((batch, d), **kw),
            "m": torch.full((batch, d), _M0, **kw)}


def slstm_block_seq(p: SLSTM, x: torch.Tensor, compute_dtype=torch.bfloat16,
                    return_state: bool = False, constrain=None):
    """sLSTM block over a sequence (a loop over time). x: (B, S, d);
    return_state=True also returns the final (h, c, n, m).
    ``constrain(t, spec)``: optional activation-sharding hook, applied to
    the (B, S, 4d) gate buffer with ("data", None, None)."""
    B, S, d = x.shape
    gates = common.dense_apply(p.w_gates, x, compute_dtype)  # (B, S, 4d)
    if constrain is not None:
        gates = constrain(gates, ("data", None, None))
    # under DTensor each device runs its batch rows' loop
    hseq, h, c, n, m = sharding.local_over(
        _slstm_loop, (gates, p.r_gates.w), ((0, None), (None, None)),
        ((0, None),) * 5)
    hseq = common.rmsnorm_apply(p.norm, hseq)
    out = common.mlp_apply(p.w_ff, hseq.to(compute_dtype), "silu",
                           compute_dtype)
    if return_state:
        return out, {"h": h, "c": c, "n": n, "m": m}
    return out


def _recurrent(r_w: torch.Tensor) -> SimpleNamespace:
    """The cell's view of an ``SLSTM``: its recurrent weight alone."""
    return SimpleNamespace(r_gates=SimpleNamespace(w=r_w, b=None))


def _slstm_loop(gates: torch.Tensor, r_w: torch.Tensor):
    """The sLSTM recurrence over gates (B, S, 4d) with recurrent weight
    ``r_w``: (h over time (B, S, d), and the final h, c, n, m). Traced on
    ``meta`` tensors under ``roofline.trace_analyzer``, one step stands for
    all S (``_SLSTMTrace``)."""
    if gates.device.type == "meta":
        analyzer = trace_analyzer.current()
        if analyzer is not None:
            return _SLSTMTrace.apply(gates, r_w, analyzer)
    B, S, d4 = gates.shape
    p = _recurrent(r_w)
    st = slstm_cache_init(B, d4 // 4, gates.device)
    h, state = st["h"], (st["c"], st["n"], st["m"])
    hs = []
    for g in gates.unbind(1):
        h, state = _slstm_cell(p, g, h, state)
        hs.append(h)
    return (torch.stack(hs, dim=1), h) + tuple(state)


class _SLSTMTrace(torch.autograd.Function):
    """``_slstm_loop`` as the dry run counts it, the counterpart of the
    HLO analyzer's trip count: one time step traced and counted S times
    (``TraceAnalyzer.scaled``), in the forward and in the backward; what
    the loop runs once (the state's init, the stack of h, the stack of the
    gates' gradient) counted once. Shapes and dtypes are the loop's; on
    ``meta`` tensors there are no values to compute. Under autograd it
    holds S times the bytes a step saves for the backward, as the loop
    does. The backward counts a middle step: the gradients it receives
    from the next step, added to h's from the stack, and the recurrent
    weight's gradient accumulated. The first and last steps do a little
    less (no gradient for the initial state, none from a step after the
    last), so the loop run step by step counts a few ops fewer, a number
    that does not grow with S."""

    @staticmethod
    def forward(ctx, gates, r_w, analyzer):
        B, S, d4 = gates.shape
        st = slstm_cache_init(B, d4 // 4, gates.device)
        with analyzer.scaled(S):
            h, state = _slstm_cell(_recurrent(r_w), gates[:, 0], st["h"],
                                   (st["c"], st["n"], st["m"]))
        ctx.analyzer = analyzer
        ctx.set_materialize_grads(False)
        saved = ()
        if any(ctx.needs_input_grad[:2]):
            with analyzer.scaled(0):
                nbytes = _step_graph(gates, r_w)[2]
            saved = (torch.empty(S * nbytes, dtype=torch.uint8,
                                 device=gates.device),)
        ctx.save_for_backward(gates, r_w, *saved)
        return (torch.stack([h] * S, dim=1), h) + tuple(state)

    @staticmethod
    def backward(ctx, g_hseq, *g_final):
        gates, r_w = ctx.saved_tensors[:2]
        S = gates.shape[1]
        analyzer = ctx.analyzer
        with torch.enable_grad():
            with analyzer.scaled(0):        # one step's graph, uncounted
                leaves, outs, _ = _step_graph(gates, r_w)
                nxt = [torch.empty_like(o) for o in outs]
            with analyzer.scaled(S):
                if g_hseq is not None:
                    nxt[0] = g_hseq[:, 0] + nxt[0]
                grads = torch.autograd.grad(outs, leaves, nxt)
                d_w = torch.empty_like(r_w) + grads[1]
        return torch.stack([grads[0]] * S, dim=1), d_w, None


def _step_graph(gates, r_w):
    """One sLSTM step under autograd on leaves: the gates' first step,
    ``r_w`` and an empty state (h, c, n, m). Returns (the leaves, the
    step's h, c, n, m, the bytes of the tensors it saves for its backward
    that it allocates)."""
    B, _, d4 = gates.shape
    state0 = [torch.empty((B, d4 // 4), device=gates.device)
              for _ in range(4)]
    leaves = [t.detach().requires_grad_()
              for t in [gates[:, 0], r_w] + state0]
    inputs = {t.untyped_storage()._cdata for t in leaves}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in inputs:
            saved[st._cdata] = st.nbytes()
        return t
    g_t, w, h0, c0, n0, m0 = leaves
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        h, state = _slstm_cell(_recurrent(w), g_t, h0, (c0, n0, m0))
    return leaves, (h,) + tuple(state), sum(saved.values())


def slstm_block_step(p: SLSTM, x_t: torch.Tensor, cache,
                     compute_dtype=torch.bfloat16):
    """One decode step. x_t: (B, 1, d). Writes the new state into
    ``cache`` and returns (out, cache)."""
    g = common.dense_apply(p.w_gates, x_t, compute_dtype)[:, 0]   # (B, 4d)
    h, state = _slstm_cell(p, g, cache["h"],
                           (cache["c"], cache["n"], cache["m"]))
    hn = common.rmsnorm_apply(p.norm, h)[:, None, :]
    out = common.mlp_apply(p.w_ff, hn.to(compute_dtype), "silu",
                           compute_dtype)
    for name, val in zip("hcnm", (h,) + state):
        cache[name].copy_(val)
    return out, cache
