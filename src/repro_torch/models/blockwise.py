"""Blockwise (flash-style) attention in plain PyTorch.

Training / prefill attention runs as a double loop over query and
key/value blocks with an online softmax (running max / normaliser), in
fp32, so memory is O(S * block) instead of O(S^2).  The loop visits the
full rectangle of (q_block, kv_block) pairs and masks, as the JAX
package's double ``lax.scan`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import attention_on_shards, on_shards

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, *, causal: bool, window: int):
    """q_pos: [qb], k_pos: [kb] -> bool [qb, kb]."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def _attend_pair(qblk, kblk, vblk, m_run, l_run, acc, q_pos, k_pos, T,
                 scale, *, causal: bool, window: int):
    """One (q-block, kv-block) pair's step of the online softmax: the
    running max, normaliser and accumulator after ``kblk`` / ``vblk``
    (keys at ``k_pos``; those at ``T`` or beyond are padding)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk) * scale
    mask = _block_mask(q_pos, k_pos, causal=causal, window=window)
    # mask out kv padding
    mask = mask & (k_pos[None, :] < T)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_run - m_new)
    l_run = l_run * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vblk)
    return m_new, l_run, acc


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, q_block: int = 512,
                        kv_block: int = 512):
    """q: [B,S,NQ,HD], k/v: [B,T,NKV,HD] -> [B,S,NQ,HD] in q's dtype.
    Under an in-node layout (DTensors) each rank runs it on its batch and
    head shards (:func:`repro_torch.sharding.attention_on_shards`)."""
    if on_shards(q):
        return attention_on_shards(
            blockwise_attention, q, k, v, causal=causal, window=window,
            q_offset=q_offset, q_block=q_block, kv_block=kv_block)
    B, S, NQ, HD = q.shape
    T, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    qb = min(q_block, S)
    kb = min(kv_block, T)
    # pad to block multiples
    q_pad, kv_pad = (-S) % qb, (-T) % kb
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    if kv_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
    nq, nk = q.shape[1] // qb, k.shape[1] // kb

    qr = q.reshape(B, nq, qb, NKV, G, HD).float()
    kr = k.reshape(B, nk, kb, NKV, HD).float()
    vr = v.reshape(B, nk, kb, NKV, HD).float()
    scale = HD ** -0.5
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = qr[:, qi]                                  # [B,qb,NKV,G,HD]
        q_pos = q_offset + qi * qb + torch.arange(qb, device=dev)
        m_run = torch.full((B, NKV, G, qb), NEG_INF, device=dev)
        l_run = torch.zeros((B, NKV, G, qb), device=dev)
        acc = torch.zeros((B, NKV, G, qb, HD), device=dev)
        for ki in range(nk):
            m_run, l_run, acc = _attend_pair(
                qblk, kr[:, ki], vr[:, ki], m_run, l_run, acc, q_pos,
                ki * kb + torch.arange(kb, device=dev), T, scale,
                causal=causal, window=window)
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]  # [B,NKV,G,qb,HD]
        outs.append(out.permute(0, 3, 1, 2, 4))               # [B,qb,NKV,G,HD]
    out = torch.cat(outs, dim=1).reshape(B, nq * qb, NQ, HD)
    return out[:, :S].to(q.dtype)
