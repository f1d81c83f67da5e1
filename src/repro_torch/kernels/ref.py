"""Plain PyTorch versions of the port's kernels (counterpart of ``repro.kernels.ref``).

These are the reference semantics: each CUDA kernel must match its plain
version to float tolerance, and they are the CPU execution path of the model
substrate (``ops.attention`` picks them for CPU tensors).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

__all__ = ["attention_ref", "decode_attention_ref", "decode_scores", "gmm_ref", "mamba_scan_ref",
           "mlstm_chunkwise_ref", "mlstm_chunked_scan", "mlstm_rounded_scan"]

#: the finite stand-in for -inf of the mLSTM stabiliser (empty state, causal
#: mask): with -inf, ``b + m_prev - m_comb`` would give NaN
NEG_INF = -1e30


def _attn_mask(
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Boolean mask (Sq, Sk): True = attend."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return ok


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention with optional causal/sliding-window mask and softcap.

    ``q_offset`` places the query block at absolute positions
    ``[q_offset, q_offset + Sq)`` against keys at ``[0, Sk)``. Math in fp32,
    output in ``q.dtype``; rows with no key to attend return 0, not NaN.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = _attn_mask(q_pos, k_pos, causal, window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    del scores  # (B, Hkv, g, Sq, Sk) fp32: 8.6 GB at mixtral's prefill
    # fully-masked rows (can happen with tiny windows) -> zeros, not NaN
    probs = torch.where(mask.any(dim=-1)[:, None], probs, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_scores(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, L, Hkv, D)
    fill_len: int,
    offset: int = 0,
) -> torch.Tensor:
    """A decode step's scores ``q.k / sqrt(D)`` in fp32, (B, Hkv, g, 1, L),
    with the slots ``offset + t >= fill_len`` at -inf."""
    B, L, Hkv, D = k.shape
    g = q.shape[2] // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, 1, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    ok = torch.arange(L, device=q.device) + offset < fill_len
    return scores.masked_fill(~ok, float("-inf"))


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, L, Hkv, D)
    v: torch.Tensor,  # (B, L, Hkv, D)
    fill_len: int,
) -> torch.Tensor:
    """Single-token attention against a cache over its slots ``[0, fill_len)``
    (a full sliding-window ring passes ``fill_len = L``): scores, softmax and
    ``P.V`` in fp32, output (B, 1, Hq, D) in ``q.dtype``. The reference's
    ``_decode_attention``, an einsum over the whole cache."""
    B, _, Hkv, D = k.shape
    probs = torch.softmax(decode_scores(q, k, fill_len), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, 1, q.shape[2], D).to(q.dtype)


def mamba_scan_ref(
    x: torch.Tensor,  # (B, T, Di)
    dt: torch.Tensor,  # (B, T, Di), post-softplus
    A: torch.Tensor,  # (Di, N), negative (continuous time)
    B: torch.Tensor,  # (B, T, N)
    C: torch.Tensor,  # (B, T, N)
    D: torch.Tensor,  # (Di,)
) -> torch.Tensor:
    """Selective SSM scan (Mamba-1 semantics), sequential over T in fp32.

    ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``; ``y_t = C_t . h_t + D x_t``,
    with ``D x`` added in fp32 before the one cast to ``x.dtype``.
    """
    Bsz, T, Di = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    h = torch.zeros((Bsz, Di, A.shape[1]), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bsz, T, Di), dtype=torch.float32, device=x.device)
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])  # (B, Di, N)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    return (ys + xf * D.float()).to(x.dtype)


def mlstm_chunkwise_ref(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, T, H, D)
    v: torch.Tensor,  # (B, T, H, D)
    i_gate: torch.Tensor,  # (B, T, H) pre-activation (exponential gate)
    f_gate: torch.Tensor,  # (B, T, H) pre-activation (through logsigmoid)
) -> torch.Tensor:
    """mLSTM with matrix memory and exponential gating, quadratic in T: the oracle.

    Per head: ``F_t = cumsum(logsigmoid(f))``, ``D_ts = F_t - F_s + i_s`` for
    ``s <= t``, ``m_t = max_s D_ts``;
    ``out_t = sum_s e^{D_ts - m_t} (q_t . k_s / sqrt(D)) v_s / den_t`` with
    ``den_t = max(|sum_s e^{D_ts - m_t} q_t . k_s / sqrt(D)|, e^{-m_t})``.
    fp32 inside, output in ``q.dtype``.
    """
    B, T, H, D = q.shape
    qf = q.float()
    kf = k.float() / math.sqrt(D)
    vf = v.float()
    lf = F.logsigmoid(f_gate.float())  # (B, T, H)
    F_ = torch.cumsum(lf, dim=1)
    Dmat = F_[:, :, None, :] - F_[:, None, :, :] + i_gate.float()[:, None, :, :]  # (B, T, S, H)
    Dmat = Dmat.permute(0, 3, 1, 2)  # (B, H, T, S)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    Dmat = Dmat.masked_fill(~causal, float("-inf"))
    m = torch.clamp_min(torch.amax(Dmat, dim=-1, keepdim=True), NEG_INF)  # s = t is never masked
    Dexp = torch.exp(Dmat - m)
    scores = torch.einsum("bthd,bshd->bhts", qf, kf)
    w = scores * Dexp
    num = torch.einsum("bhts,bshd->bthd", w, vf)
    den = torch.maximum(torch.abs(torch.sum(w, dim=-1)), torch.exp(-m[..., 0]))  # (B, H, T)
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype)


def mlstm_chunked_scan(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, T, H)
    f_gate: torch.Tensor,  # (B, T, H)
    chunk: int = 256,
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Chunkwise mLSTM, a loop over chunks of ``L = min(chunk, T)`` with a
    ``(B, H, D, D)`` fp32 carry: O(T * L) memory, the model's plain path.

    Per chunk: a causal, gate-decayed ``L x L`` product of q and k applied to
    v, plus the carried state's term ``q C``, over the stabilised
    denominator; then the state ``(C, n, m)`` is updated. Mathematically the
    same as :func:`mlstm_chunkwise_ref`. fp32 inside (``dtype``: float64 gives
    an accuracy reference), output in ``q.dtype``.
    """
    B, T, H, D = q.shape
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"mlstm_chunked_scan: T={T} is not a multiple of the chunk {L}")
    nc = T // L
    scale = 1.0 / math.sqrt(D)

    def rs(x: torch.Tensor) -> torch.Tensor:  # (B, T, H, *) -> (nc, B, H, L, *)
        x = x.reshape(B, nc, L, H, *x.shape[3:])
        return x.movedim(1, 0).transpose(2, 3)

    qf = rs(q.to(dtype))
    kf = rs(k.to(dtype) * scale)
    vf = rs(v.to(dtype))
    ii = rs(i_gate.to(dtype))
    lf = rs(F.logsigmoid(f_gate.to(dtype)))
    t_idx = torch.arange(L, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]

    C_p = torch.zeros((B, H, D, D), dtype=dtype, device=q.device)
    n_p = torch.zeros((B, H, D), dtype=dtype, device=q.device)
    m_p = torch.full((B, H), NEG_INF, dtype=dtype, device=q.device)
    outs = []
    for c in range(nc):
        qc, kc, vc, ic, lc = qf[c], kf[c], vf[c], ii[c], lf[c]
        b = torch.cumsum(lc, dim=-1)  # (B, H, L)
        g = b[..., -1]
        Dm = b[..., :, None] - b[..., None, :] + ic[..., None, :]
        Dm = torch.where(causal, Dm, torch.full_like(Dm, NEG_INF))
        m_inter = b + m_p[..., None]
        m_comb = torch.maximum(torch.amax(Dm, dim=-1), m_inter)
        dexp = torch.exp(Dm - m_comb[..., None])
        w = torch.einsum("bhld,bhsd->bhls", qc, kc) * dexp
        inter_w = torch.exp(m_inter - m_comb)
        num = torch.einsum("bhls,bhsd->bhld", w, vc) + inter_w[..., None] * torch.einsum(
            "bhld,bhde->bhle", qc, C_p
        )
        den = torch.sum(w, dim=-1) + inter_w * torch.einsum("bhld,bhd->bhl", qc, n_p)
        den = torch.maximum(torch.abs(den), torch.exp(-m_comb))
        outs.append(num / den[..., None])
        key_w = g[..., None] - b + ic
        m_new = torch.maximum(g + m_p, torch.amax(key_w, dim=-1))
        kscaled = kc * torch.exp(key_w - m_new[..., None])[..., None]
        decay = torch.exp(g + m_p - m_new)
        C_p = decay[..., None, None] * C_p + torch.einsum("bhld,bhle->bhde", kscaled, vc)
        n_p = decay[..., None] * n_p + torch.sum(kscaled, dim=-2)
        m_p = m_new
    out = torch.stack(outs).transpose(2, 3).movedim(0, 1).reshape(B, T, H, D)
    return out.to(q.dtype)


def _split(x: torch.Tensor) -> torch.Tensor:
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, ties away from zero (cvt.rna.tf32.f32)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


_ROUNDING = {"exact": lambda x: x, "split": _split, "bf16": lambda x: x.bfloat16().float(), "tf32": _tf32}


def mlstm_rounded_scan(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, T, H)
    f_gate: torch.Tensor,  # (B, T, H)
    *,
    operands: str = "split",
    chunk: int = 128,
) -> torch.Tensor:
    """The chunked scan with the rounding of the CUDA kernel's wgmma route
    (``kernels/csrc/mlstm.cu``), fp32 inside, any T: a model of where that
    route rounds, for checking a precision plan without the card.

    As the kernel: S = q k^T from the inputs as they are; W = S / sqrt(D)
    times the decay matrix, its row sums, q.n and the denominator in fp32 from
    unrounded values; the numerator q C (scaled per row) plus W v, where W,
    the key-weighted k (k kw / sqrt(D)) of the state update and the state C
    enter the products rounded by ``operands``: ``"split"`` (bf16 hi + lo, the
    kernel), ``"bf16"`` (once), ``"tf32"``, or ``"exact"`` (fp32). Ragged T is
    padded as the kernel masks it. Output in q's type.
    """
    rnd = _ROUNDING[operands]
    B, T, H, D = q.shape
    L = chunk
    nc = -(-T // L)
    pad = nc * L - T
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32

    def rs(x: torch.Tensor) -> torch.Tensor:  # (B, T, H, *) -> (nc, B, H, L, *), zeros past T
        x = F.pad(x.to(f32), (0, 0) * (x.dim() - 2) + (0, pad))
        return x.reshape(B, nc, L, H, *x.shape[3:]).movedim(1, 0).transpose(2, 3)

    qf, kf, vf, ii = rs(q), rs(k), rs(v), rs(i_gate)
    lf = F.logsigmoid(rs(f_gate))
    t_idx = torch.arange(L, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    C = torch.zeros((B, H, D, D), dtype=f32, device=q.device)
    n = torch.zeros((B, H, D), dtype=f32, device=q.device)
    m = torch.full((B, H), NEG_INF, dtype=f32, device=q.device)
    outs = []
    for c in range(nc):
        qc, kc, vc, ic, lc = qf[c], kf[c], vf[c], ii[c], lf[c]
        b = torch.cumsum(lc, dim=-1)
        g = b[..., -1]
        Dm = torch.where(causal, b[..., :, None] - b[..., None, :] + ic[..., None, :],
                         torch.full((), NEG_INF, dtype=f32, device=q.device))
        m_inter = b + m[..., None]
        m_comb = torch.maximum(Dm.amax(-1), m_inter)
        W = (qc @ kc.transpose(-1, -2)) * scale * torch.exp(Dm - m_comb[..., None])
        iw = torch.exp(m_inter - m_comb)
        den = W.sum(-1) + iw * (qc @ n[..., None])[..., 0]
        den = torch.maximum(den.abs(), torch.exp(-m_comb))
        num = (qc @ rnd(C)) * iw[..., None] + rnd(W) @ vc
        outs.append(num / den[..., None])
        key = g[..., None] - b + ic
        m_new = torch.maximum(g + m, key.amax(-1))
        decay = torch.exp(g + m - m_new)
        kwk = kc * (scale * torch.exp(key - m_new[..., None]))[..., None]
        C = decay[..., None, None] * C + rnd(kwk).transpose(-1, -2) @ vc
        n = decay[..., None] * n + kwk.sum(-2)
        m = m_new
    out = torch.stack(outs).transpose(2, 3).movedim(0, 1).reshape(B, nc * L, H, D)[:, :T]
    return out.to(q.dtype)


# ------------------------------ grouped matmul ------------------------------


def gmm_ref(
    lhs: torch.Tensor,  # (M, K) rows sorted by group
    rhs: torch.Tensor,  # (G, K, N) per-group weights
    group_sizes: Union[torch.Tensor, Sequence[int]],  # (G,), sum == M
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped matmul: the rows of each group hit their group's ``rhs`` matrix.

    Products and sums in fp32, output in ``lhs``'s type or ``out_dtype``
    (``repro.kernels.ref.gmm_ref`` semantics). The reference gathers an (M, K,
    N) weight tensor; this loops over the groups instead, one fp32 product per
    group's rows, and upcasts one group's weights at a time.
    """
    M, K = lhs.shape
    G, K2, N = rhs.shape
    # lint: waive[JP003] ragged groups loop on the host; callers pass a list (moe: [C] * E)
    sizes = [int(s) for s in (group_sizes.tolist() if torch.is_tensor(group_sizes) else group_sizes)]
    if K2 != K or len(sizes) != G or sum(sizes) != M or min(sizes, default=0) < 0:
        raise ValueError(f"gmm_ref: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, group sizes "
                         f"{sizes}: need matching K, G sizes and a sum of M")
    out = torch.empty((M, N), dtype=lhs.dtype if out_dtype is None else out_dtype, device=lhs.device)
    start = 0
    for g, size in enumerate(sizes):
        rows = slice(start, start + size)
        out[rows] = torch.matmul(lhs[rows].float(), rhs[g].float())
        start += size
    return out
