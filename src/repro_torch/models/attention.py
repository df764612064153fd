"""Chunked online-softmax attention and one-token decode attention.

The subset of ``repro/models/attention.py`` that the serving slice runs:
``flash_chunked_stats``/``flash_chunked``/``_finalize`` and
``decode_attend``/``decode_update_attend`` (its local branch,
``_decode_local`` without sequence sharding).  Prefill attention of the
dense and MoE blocks goes through the flash-attention kernel instead
(``models/transformer.py``); decode attention stays here, in plain
PyTorch, because it attends one query at absolute position ``pos``
against a ring cache whose slots carry their own positions and a
validity mask, which the kernel's implicit ``0..S-1`` positions cannot
express — in the reference too it is XLA code outside any Pallas kernel.
``sliding_window_attention``, ``hierarchical_causal`` and
``block_causal`` are not on this path and wait (ROADMAP queue A16).

q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd) with GQA groups G = H // KV.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _masked_softmax_update(carry, logits, mask, vc):
    """One online-softmax accumulation step (all f32)."""
    m, l, acc = carry
    logits = torch.where(mask, logits, NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vc.dtype), vc).float()
    return m_new, l_new, acc * alpha[..., None] + pv


def _finalize(m, l, acc, B, Sq, H, hd, dtype):
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = torch.where((l > 0)[..., None], out, 0.0)
    # (B, KV, G, Sq, hd) -> (B, Sq, KV*G=H, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(dtype)


def flash_chunked_stats(q, k, v, q_pos, k_pos, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        k_valid=None, chunk: int = 1024):
    """Unnormalized online-softmax stats (m, l, acc) over KV chunks.

    q_pos: (B, Sq) or (Sq,) absolute query positions; k_pos: (B, Sk) or
    (Sk,) absolute key positions (ring caches pass their slot->position
    map); k_valid: optional (B, Sk) or (Sk,) validity mask.  Returns m, l
    (B, KV, G, Sq) and acc (B, KV, G, Sq, hd), all f32.  The last chunk
    may be short: the reference pads it with invalid keys, which change
    none of the three."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    if q_pos.dim() == 1:
        q_pos = q_pos[None].expand(B, Sq)
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(B, Sk)
    if k_valid is None:
        k_valid = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    elif k_valid.dim() == 1:
        k_valid = k_valid[None].expand(B, Sk)

    qr = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)   # B,KV,G,Sq,hd
    m = torch.full((B, KV, G, Sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    c = min(chunk, Sk)
    for s in range(0, Sk, c):
        kc, vc = k[:, s:s + c], v[:, s:s + c]
        kpos_c, kval_c = k_pos[:, s:s + c], k_valid[:, s:s + c]
        logits = torch.einsum("bkgqh,bckh->bkgqc", qr, kc).float() * scale
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        mask = kval_c[:, None, :]                               # (B, 1, c)
        if causal:
            mask = mask & (kpos_c[:, None, :] <= q_pos[:, :, None])
        if window:
            mask = mask & (q_pos[:, :, None] - kpos_c[:, None, :] < window)
        m, l, acc = _masked_softmax_update((m, l, acc), logits,
                                           mask[:, None, None], vc)
    return m, l, acc


def flash_chunked(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                  softcap=0.0, k_valid=None, chunk=1024) -> torch.Tensor:
    """Online-softmax attention, scanning KV in chunks (see stats fn)."""
    B, Sq, H, hd = q.shape
    m, l, acc = flash_chunked_stats(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window, softcap=softcap,
                                    k_valid=k_valid, chunk=chunk)
    return _finalize(m, l, acc, B, Sq, H, hd, q.dtype)


def decode_attend(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                  softcap: float = 0.0, chunk: int = 2048) -> torch.Tensor:
    """One-token attention against a (possibly ring) KV cache.

    q: (B, 1, H, hd); caches: (B, L, KV, hd); slot_pos: (B, L) absolute
    position stored in each slot (-1 = never written); pos: (B,)."""
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    return flash_chunked(q, k_cache, v_cache, pos[:, None], slot_pos,
                         causal=True, window=window, softcap=softcap,
                         k_valid=valid, chunk=chunk)


def decode_update_attend(q, k_new, v_new, ck, cv, slot_pos, pos, *,
                         window: int = 0, softcap: float = 0.0,
                         chunk: int = 2048):
    """Write the new token's K/V into the cache slot ``pos % L`` and
    attend.  q/k_new/v_new: (B, 1, H|KV, hd); ck/cv: (B, L, KV, hd);
    slot_pos: (B, L); pos: (B,).  Unlike the reference, which returns new
    arrays, the three cache tensors are updated in place (saving a copy
    of every layer's cache a token) and returned."""
    B = slot_pos.shape[0]
    bidx = torch.arange(B, device=slot_pos.device)
    slot = (pos % ck.shape[1]).long()
    ck[bidx, slot] = k_new[:, 0]
    cv[bidx, slot] = v_new[:, 0]
    slot_pos[bidx, slot] = pos.to(slot_pos.dtype)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    m, l, acc = flash_chunked_stats(q, ck, cv, pos[:, None], slot_pos,
                                    causal=True, window=window,
                                    softcap=softcap, k_valid=valid,
                                    chunk=chunk)
    _, _, H, hd = q.shape
    return _finalize(m, l, acc, B, 1, H, hd, q.dtype), ck, cv, slot_pos
