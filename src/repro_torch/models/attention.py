"""Chunked online-softmax, flash-kernel, sliding-window, hierarchical,
block-banded and one-token decode attention.

The serving half of ``repro/models/attention.py``:
``flash_chunked_stats``/``flash_chunked``/``_finalize``,
``sliding_window_attention``, ``hierarchical_causal``, ``block_causal``
and ``decode_attend``/``decode_update_attend`` (its local branch,
``_decode_local`` without sequence sharding).  Prefill attention of
every block and every cross-attention call go through the
flash-attention kernel's wrapper (``flash``): causal self-attention,
with ``window`` for local blocks (``sliding_window_attention``, the
reference's blocked band, exact, computed here without the blocks),
non-causal for an encoder, and non-causal against the encoder's
``S_enc`` keys for cross-attention at prefill and at decode (``Sq =
1``).  ``hierarchical_causal`` and ``block_causal`` run only under
``attn_impl`` ``"hier"`` and ``"block"``; they are XLA code in the
reference with no Pallas source, plain PyTorch here.  Decode
self-attention stays in plain PyTorch, because it attends one query at
absolute position ``pos`` against a ring cache whose slots carry their
own positions and a validity mask, which the kernel's implicit
``0..S-1`` positions cannot express — in the reference too it is XLA
code outside any Pallas kernel.

q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd) with GQA groups G = H // KV.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as FA

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


def _heads_to_batch(x):
    """(B, S, H, hd) -> (B*H, S, hd)."""
    B, S, H, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, hd)


def flash(q, k, v, *, causal: bool = True, window: int = 0,
          softcap: float = 0.0) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd), the
    queries at positions 0..Sq-1 and the keys at 0..Sk-1 (``causal``:
    query p attends keys kpos <= p; ``window`` > 0: p - window < kpos):
    one call of the flash-attention kernel's wrapper on (B*H, S, hd)
    views, the KV heads repeated to full heads.  -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    o = FA.flash_attention(_heads_to_batch(q), _heads_to_batch(k),
                           _heads_to_batch(v), causal=causal, window=window,
                           softcap=softcap)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


def sliding_window_attention(q, k, v, q_pos, *, window: int,
                             softcap: float = 0.0) -> torch.Tensor:
    """Exact sliding-window attention for prefill (positions 0..S-1), the
    reference's band ``0 <= q_pos - k_pos < window``: ``flash`` causal
    with ``window``.  ``q_pos`` is taken for the reference's signature;
    the positions are 0..S-1 as there."""
    del q_pos
    return flash(q, k, v, causal=True, window=window, softcap=softcap)


def _stats(qq, kk, vv, mask, scale, softcap):
    """Partial attention stats of ``hierarchical_causal``.  qq: (..., Lq,
    KV, G, hd), kk/vv: (..., Lk, KV, hd) -> m, l (..., KV, G, Lq), acc
    (..., KV, G, Lq, hd), all f32."""
    logits = torch.einsum("...qkgh,...ckh->...kgqc", qq, kk).float() * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        logits = torch.where(mask, logits, NEG)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    acc = torch.einsum("...kgqc,...ckh->...kgqh", p.to(vv.dtype), vv).float()
    return m, p.sum(dim=-1), acc


def _merge(s1, s2):
    m1, l1, a1 = s1
    m2, l2, a2 = s2
    m = torch.maximum(m1, m2)
    e1, e2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return m, l1 * e1 + l2 * e2, a1 * e1[..., None] + a2 * e2[..., None]


def hierarchical_causal(q, k, v, *, softcap: float = 0.0,
                        base_chunk: int = 1024) -> torch.Tensor:
    """Exact causal attention with ~zero masking waste: the causal matrix
    [A 0; B C] has an unmasked off-diagonal rectangle B; recurse on A and
    C.  The rectangles of one level have one shape, so each level is one
    batched product; only the block diagonal (S/c blocks of c^2) is
    masked.  Partial results merge through online-softmax (m, l, acc)
    stats.  S must be a multiple of ``min(base_chunk, S)``, as the
    reference asserts."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    c = min(base_chunk, S)
    if S % c:
        raise ValueError("hierarchical_causal: S must be divisible by chunk")
    nb = S // c
    qr = q.reshape(B, S, KV, G, hd)

    # diagonal blocks (the only masked compute), expanded to all of S
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    md, ld, ad = _stats(qr.reshape(B, nb, c, KV, G, hd),
                        k.reshape(B, nb, c, KV, hd),
                        v.reshape(B, nb, c, KV, hd), tri, scale, softcap)
    m_tot = md.permute(0, 2, 3, 1, 4).reshape(B, KV, G, S)
    l_tot = ld.permute(0, 2, 3, 1, 4).reshape(B, KV, G, S)
    a_tot = ad.permute(0, 2, 3, 1, 4, 5).reshape(B, KV, G, S, hd)

    # off-diagonal rectangles, level by level: rectangle r has query rows
    # [r span + half, (r + 1) span) and keys [r span, r span + half)
    span = S
    while span > c:
        half = span // 2
        n_rect = S // span
        q_lvl = qr.reshape(B, n_rect, span, KV, G, hd)[:, :, half:]
        k_lvl = k.reshape(B, n_rect, span, KV, hd)[:, :, :half]
        v_lvl = v.reshape(B, n_rect, span, KV, hd)[:, :, :half]
        m2, l2, a2 = _stats(q_lvl, k_lvl, v_lvl, None, scale, softcap)
        qidx = (torch.arange(n_rect, device=q.device)[:, None] * span + half
                + torch.arange(half, device=q.device)[None, :]).reshape(-1)
        new = (m2.permute(0, 2, 3, 1, 4).reshape(B, KV, G, n_rect * half),
               l2.permute(0, 2, 3, 1, 4).reshape(B, KV, G, n_rect * half),
               a2.permute(0, 2, 3, 1, 4, 5).reshape(B, KV, G, n_rect * half,
                                                    hd))
        mm, lm, am = _merge((m_tot[..., qidx], l_tot[..., qidx],
                             a_tot[..., qidx, :]), new)
        m_tot[..., qidx] = mm
        l_tot[..., qidx] = lm
        a_tot[..., qidx, :] = am
        span = half
    return _finalize(m_tot, l_tot, a_tot, B, S, H, hd, q.dtype)


def block_causal(q, k, v, *, softcap: float = 0.0,
                 chunk: int = 1024) -> torch.Tensor:
    """Exact causal attention with block-banded compute: query chunk i
    attends keys ``[0, (i + 1) c)``, a static slice, so only the diagonal
    c x c blocks are masked; each chunk is one softmax over its visible
    span.  S must be a multiple of ``min(chunk, S)``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    c = min(chunk, S)
    if S % c:
        raise ValueError("block_causal: S must divide by chunk")
    nb = S // c
    qr = q.reshape(B, nb, c, KV, G, hd)
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    outs = []
    for i in range(nb):
        span = (i + 1) * c
        logits = torch.einsum("bqkgh,bckh->bkgqc", qr[:, i],
                              k[:, :span]).float() * scale
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        # only the trailing diagonal block needs masking
        mask = torch.cat([torch.ones((c, i * c), dtype=torch.bool,
                                     device=q.device), tri], dim=1)
        w = torch.softmax(torch.where(mask, logits, NEG), dim=-1)
        outs.append(torch.einsum("bkgqc,bckh->bkgqh", w.to(q.dtype),
                                 v[:, :span]).float())
    out = torch.cat(outs, dim=3)                        # (B, KV, G, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def decode_attend(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                  softcap: float = 0.0, chunk: int = 2048) -> torch.Tensor:
    """One-token attention against a (possibly ring) KV cache.

    q: (B, 1, H, hd); caches: (B, L, KV, hd); slot_pos: (B, L) absolute
    position stored in each slot (-1 = never written); pos: (B,)."""
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    return flash_chunked(q, k_cache, v_cache, pos[:, None], slot_pos,
                         causal=True, window=window, softcap=softcap,
                         k_valid=valid, chunk=chunk)


def _decode_local(q, k_new, v_new, ck, cv, sp, pos, *, window: int,
                  softcap: float, chunk: int):
    """Write the new token into its slot ``pos % L`` of the (ring) cache
    and attend over every valid slot: the reference's ``_decode_local``
    on one device (no sequence shards).  The three cache tensors are
    updated in place and returned."""
    B = sp.shape[0]
    bidx = torch.arange(B, device=sp.device)
    slot = (pos % ck.shape[1]).long()
    ck[bidx, slot] = k_new[:, 0]
    cv[bidx, slot] = v_new[:, 0]
    sp[bidx, slot] = pos.to(sp.dtype)
    valid = (sp >= 0) & (sp <= pos[:, None])
    m, l, acc = flash_chunked_stats(q, ck, cv, pos[:, None], sp,
                                    causal=True, window=window,
                                    softcap=softcap, k_valid=valid,
                                    chunk=chunk)
    _, _, H, hd = q.shape
    return _finalize(m, l, acc, B, 1, H, hd, q.dtype), ck, cv, sp


def decode_update_attend(q, k_new, v_new, ck, cv, slot_pos, pos, *,
                         window: int = 0, softcap: float = 0.0,
                         chunk: int = 2048):
    """Write the new token's K/V into the cache slot ``pos % L`` and
    attend; ``L`` is the full cache or a local layer's ring of
    ``min(window, cache_len)`` slots.  q/k_new/v_new: (B, 1, H|KV, hd);
    ck/cv: (B, L, KV, hd); slot_pos: (B, L); pos: (B,).  Unlike the
    reference, which returns new arrays, the three cache tensors are
    updated in place (saving a copy of every layer's cache a token) and
    returned."""
    return _decode_local(q, k_new, v_new, ck, cv, slot_pos, pos,
                         window=window, softcap=softcap, chunk=chunk)
