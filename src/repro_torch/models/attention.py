"""Attention (the reference's ``models/attention.py``): blocked
(online-softmax) GQA with causal/local/full masking, plus the
single-token decode path against a KV cache.

Written in plain torch as the reference writes it (a loop over KV blocks
with a running max and sum); ``F.scaled_dot_product_attention`` is not
used, because its masked-row and window semantics are not the
reference's.

GQA: prefill repeats each KV head G = H/Kh times (``repeat_interleave``:
head h reads KV head h // G), and decode factors q as (Kh, G), which maps
head h to the same KV head.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k, H: int):
    """(B, S, Kh, D) → (B, S, H, D) by repeating each kv head G times."""
    Kh = k.shape[2]
    if Kh == H:
        return k
    return torch.repeat_interleave(k, H // Kh, dim=2)


def blocked_attention(q, k, v, *, causal: bool = True,
                      window: int = 0, block: int = 1024,
                      q_offset: int = 0):
    """Memory-safe attention. q: (B,Sq,H,D), k/v: (B,Skv,Kh,D).

    window > 0 → local (sliding-window) causal attention.
    q_offset: absolute position of q[0] relative to k[0] (prefill chunking).
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scale = D ** -0.5
    block = min(block, Skv)
    while Skv % block:
        block //= 2
    nblk = Skv // block
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for blk_idx in range(nblk):
        k_blk = k[:, blk_idx * block:(blk_idx + 1) * block]
        v_blk = v[:, blk_idx * block:(blk_idx + 1) * block]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
        k_pos = blk_idx * block + torch.arange(block, device=dev)
        mask = torch.ones((Sq, block), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        # fully-masked rows: s == m_new == NEG_INF → exp(0) = 1; zero them
        p = p * mask[None, None]
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype), v_blk).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,H,Sq,D)
    return out.permute(0, 2, 1, 3).to(q.dtype)            # (B,Sq,H,D)


def decode_attention(q, k_cache, v_cache, length, *, window: int = 0):
    """Single-token attention. q: (B,1,H,D); caches: (B,Smax,Kh,D);
    length: (B,) valid cache lengths (the new token's k/v already written).

    The GQA einsum stays factored (q reshaped (Kh, G)), so the cache is
    never repeated to H heads."""
    B, _, H, D = q.shape
    Smax, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    qg = q.reshape(B, 1, Kh, G, D)
    dt = torch.promote_types(qg.dtype, k_cache.dtype)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(dt), k_cache.to(dt)
                     ).float() * (D ** -0.5)              # (B,Kh,G,1,Smax)
    pos = torch.arange(Smax, device=q.device)[None, :]    # (1,Smax)
    valid = pos < length[:, None]
    if window:
        valid &= pos >= (length[:, None] - window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache)
    return out.reshape(B, 1, H, D).to(q.dtype)
