"""Plain PyTorch blocks of the references under ``perfbench/reference``.

float32 throughout (TF32 off: :func:`fp32_matmuls`), no kernel, no cache, no
batching trick; computed in blocks of rows so that a cell's sizes fit beside
its weights. Imports nothing of the program. The equations are the
program's as it runs them (its departures from the published models are
listed in each configuration's file), written out independently:

* RMSNorm ``x / sqrt(mean(x^2) + eps) * scale``; split-half rotary embedding;
* causal GQA attention with an optional window (keys ``q - window < k <= q``);
* a top-k router over softmax probabilities, weights renormalised where the
  file says so, and a capacity of ``ceil(T k / E * factor)`` copies an expert
  for each group of T tokens, filled in token order (top-1 copy before top-2
  within a token): a copy beyond it is dropped. Inside
  :func:`record_routing`, each MoE block also records the copies each expert
  keeps in each group (the rows the expert products need);
* SwiGLU experts and dense MLP;
* the mamba mixer: in-projection, depthwise causal conv and silu, the
  selective projections, softplus step, the selective scan
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t . h_t + D x_t``,
  the silu gate and the out-projection. The scan runs in chunks: each
  chunk's own states from zero, then the carries between chunks, then the
  carried state decayed into each chunk (the same sums in another order).

``lowp=True`` is the precision control: every product with a weight that
the program keeps in bf16 takes operands rounded to float8 e4m3 (per-row
scales for activations, one scale a weight), summed in fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

from yardstick.model import Shape

__all__ = ["fp32_matmuls", "mm", "rmsnorm", "rope", "attention", "attention_block", "moe_block",
           "mlp_block", "mamba_block", "scan", "embed", "by_rows", "record_routing"]

FP8_MAX = 448.0  # largest float8 e4m3 number
ELEMS = 1 << 26  # numbers in one block of an intermediate (256 MB in fp32)
_routing: Optional[List[torch.Tensor]] = None  # the list record_routing fills


def fp32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    amax = x.abs().amax(dim=-1, keepdim=True) if per_row else x.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """``x @ w`` in fp32 (``w`` upcast), or with fp8 operands under ``lowp``."""
    wf = w.float()
    if lowp:
        return _fp8(x, True) @ _fp8(wf, False)
    return x @ wf


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): pairs (i, i + D/2) rotated by position * theta^(-2i/D)."""
    half = x.shape[-1] // 2
    i = torch.arange(0, half, dtype=torch.float32, device=x.device)
    inv = 1.0 / theta ** (i * 2 / x.shape[-1])
    ang = positions.float()[:, None] * inv[None]  # (S, D/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    """Causal GQA softmax attention, blocks of queries. q (B, S, Hq, D), k and
    v (B, S, Hkv, D) -> (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    out = torch.empty_like(q)
    kt = k.permute(0, 2, 3, 1)  # (B, Hkv, D, S)
    vt = v.permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    blk = max(1, min(S, ELEMS // max(1, B * Hq * S)))
    for q0 in range(0, S, blk):
        q1 = min(S, q0 + blk)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        qb = q[:, q0:q1].reshape(B, q1 - q0, Hkv, g, D).permute(0, 2, 3, 1, 4)  # (B, Hkv, g, bq, D)
        s = torch.matmul(qb, kt[:, :, None, :, k0:q1]) / math.sqrt(D)  # (B, Hkv, g, bq, bk)
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        ok = kp <= qp
        if window is not None:
            ok &= kp > qp - window
        s = s.masked_fill(~ok, float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), vt[:, :, None, k0:q1])  # (B, Hkv, g, bq, D)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, q1 - q0, Hq, D)
    return out


def attention_block(x: torch.Tensor, norm: torch.Tensor, p: Dict[str, Any], shape: Shape,
                    lowp: bool) -> torch.Tensor:
    """The attention sub-layer's output (no residual): RMSNorm, projections,
    rope at positions 0..S-1, attention, output projection."""
    B, S, _ = x.shape
    x = rmsnorm(x, norm, shape.eps)
    hd = shape.head_dim
    pos = torch.arange(S, device=x.device)
    q = mm(x, p["wq"], lowp).view(B, S, shape.heads, hd)
    k = mm(x, p["wk"], lowp).view(B, S, shape.kv_heads, hd)
    v = mm(x, p["wv"], lowp).view(B, S, shape.kv_heads, hd)
    if shape.rope_theta is not None:
        q, k = rope(q, pos, shape.rope_theta), rope(k, pos, shape.rope_theta)
    o = attention(q, k, v, shape.window)
    return mm(o.reshape(B, S, -1), p["wo"], lowp)


def _swiglu(x: torch.Tensor, w_gate, w_up, w_down, lowp: bool) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, lowp)) * mm(x, w_up, lowp), w_down, lowp)


def mlp_block(x: torch.Tensor, norm: torch.Tensor, p: Dict[str, Any], shape: Shape,
              lowp: bool) -> torch.Tensor:
    """The dense MLP sub-layer's output (no residual): RMSNorm, SwiGLU."""
    return _swiglu(rmsnorm(x, norm, shape.eps), p["w_gate"], p["w_up"], p["w_down"], lowp)


@contextlib.contextmanager
def record_routing() -> Iterator[List[torch.Tensor]]:
    """Inside it, every fp32 MoE block appends the copies each expert keeps
    in each of its dispatch groups: a (groups, experts) tensor a block, in
    the order the blocks run."""
    global _routing
    outer, _routing = _routing, []
    try:
        yield _routing
    finally:
        _routing = outer


def moe_block(x: torch.Tensor, norm: torch.Tensor, p: Dict[str, Any], shape: Shape, groups: str,
              lowp: bool) -> torch.Tensor:
    """The MoE sub-layer's output (no residual) for x (B, S, d): RMSNorm,
    router, capacity, experts, the weighted sum of each token's kept copies.

    ``groups``: ``"batch"`` (all B*S tokens form one dispatch group, as one
    prefill call does) or ``"position"`` (the B tokens at each position form
    a group, as one decode step does).
    """
    B, S, d = x.shape
    E, k = shape.experts, shape.top_k
    x = rmsnorm(x, norm, shape.eps)
    probs = torch.softmax(x @ p["router"].float(), dim=-1)  # the router is fp32 in the program
    w, e = torch.topk(probs, k, dim=-1)
    if shape.renormalize:
        w = w / w.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(e, E)  # (B, S, k, E)
    if groups == "batch":
        queue = onehot.reshape(1, B * S * k, E)
    else:
        queue = onehot.permute(1, 0, 2, 3).reshape(S, B * k, E)
    cap = math.ceil(queue.shape[1] / E * shape.capacity_factor)  # T k / E * factor
    place = ((torch.cumsum(queue, dim=1) - 1) * queue).sum(-1)  # each copy's place in its queue
    kept_q = place < cap
    if _routing is not None and not lowp:
        _routing.append((queue * kept_q[..., None]).sum(dim=1))
    if groups == "batch":
        kept = kept_q.reshape(B, S, k)
    else:
        kept = kept_q.reshape(S, B, k).permute(1, 0, 2)
    xf = x.reshape(B * S, d)
    out = torch.zeros_like(xf)
    tok = torch.arange(B * S, device=x.device)[:, None].expand(B * S, k).reshape(-1)
    ef, wf, keptf = e.reshape(-1), w.reshape(-1), kept.reshape(-1)
    for ex in range(E):
        sel = torch.nonzero((ef == ex) & keptf).flatten()
        if sel.numel() == 0:
            continue
        step = max(1, ELEMS // shape.expert_ff)
        for s0 in range(0, sel.numel(), step):
            rows = sel[s0 : s0 + step]
            y = _swiglu(xf[tok[rows]], p["w_gate"][ex], p["w_up"][ex], p["w_down"][ex], lowp)
            out.index_add_(0, tok[rows], y * wf[rows, None])
    return out.view(B, S, d)


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
         D: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The selective scan from a zero state, fp32. x, dt (B, T, Di); A (Di, N);
    Bm, Cm (B, T, N); D (Di,) -> y (B, T, Di)."""
    Bsz, T, Di = x.shape
    N = A.shape[1]
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def chunks(t):  # (B, T, F) -> (B, nc, chunk, F), zero-padded (dt 0: the state stays)
        return F.pad(t, (0, 0, 0, pad)).view(Bsz, nc, chunk, t.shape[-1])

    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    y = torch.empty((Bsz, nc, chunk, Di), dtype=torch.float32, device=x.device)
    cb = max(1, min(Di, ELEMS // max(1, Bsz * nc * N)))
    for c0 in range(0, Di, cb):
        c1 = min(Di, c0 + cb)
        a = A[c0:c1]
        h = torch.zeros((Bsz, nc, c1 - c0, N), dtype=torch.float32, device=x.device)
        decay = torch.ones_like(h)
        for s in range(chunk):  # each chunk's own states
            da = torch.exp(dtc[:, :, s, c0:c1, None] * a)
            dtx = dtc[:, :, s, c0:c1] * xc[:, :, s, c0:c1]
            h = da * h + dtx[..., None] * Bc[:, :, s, None, :]
            decay = decay * da
            y[:, :, s, c0:c1] = torch.einsum("bcdn,bcn->bcd", h, Cc[:, :, s])
        carry = torch.zeros_like(h)  # the state entering each chunk
        state = torch.zeros_like(h[:, 0])
        for c in range(nc):
            carry[:, c] = state
            state = decay[:, c] * state + h[:, c]
        for s in range(chunk):  # the entering state, decayed into the chunk
            carry = carry * torch.exp(dtc[:, :, s, c0:c1, None] * a)
            y[:, :, s, c0:c1] += torch.einsum("bcdn,bcn->bcd", carry, Cc[:, :, s])
    y = y.view(Bsz, nc * chunk, Di)[:, :T]
    return y + x * D


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: out_t = sum_j x_{t-j} w[j] (x (B, T, C), w (W, C))."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, W - 1 - j : W - 1 - j + T] * w[j].float() for j in range(W))


def mamba_block(x: torch.Tensor, p: Dict[str, Any], shape: Shape, lowp: bool) -> torch.Tensor:
    """The mamba layer's output with its residual (the mixer carries its own norm)."""
    n, r = shape.mamba_state, shape.mamba_dt_rank
    h = rmsnorm(x, p["norm"]["scale"], shape.eps)
    xin, z = mm(h, p["w_in"], lowp).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xin, p["conv"]))
    dt_in, Bm, Cm = mm(xc, p["w_xdbc"], lowp).split([r, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["w_dt"].float() + p["dt_bias"].float())  # fp32 in the program
    A = -torch.exp(p["log_a"].float())
    y = scan(xc, dt, A, Bm, Cm, p["d_skip"].float())
    return x + mm(y * F.silu(z), p["w_out"], lowp)


def embed(table: torch.Tensor, tokens: torch.Tensor, scale: float) -> torch.Tensor:
    return table[tokens].float() * scale


def by_rows(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, *args)`` over blocks of x's rows (B, S, d) -> (B, S, d), for the
    sub-layers that treat each sequence alone: their widest intermediates
    stay near a GiB."""
    B, S, d = x.shape
    rows = max(1, (1 << 28) // (S * d * 4))
    return torch.cat([fn(x[r0 : r0 + rows], *args) for r0 in range(0, B, rows)])
