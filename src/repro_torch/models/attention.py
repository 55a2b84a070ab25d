"""GQA attention (PyTorch port of ``repro.models.attention``, GQA only).

    params = gqa_init(gen, cfg, dtype, device)
    y, cache = gqa_apply(params, cfg, x, positions, cache=None|dict)

* ``cache=None`` — full causal (or bidirectional) forward, no state.
* dense cache ``{"k": (B, T, Hkv, D), "v": (B, T, Hkv, Dv), "len": int}``
  — prefill chunks and S=1 decode steps write their K/V at ``len`` and
  attend over the live prefix.  ``len`` is a host int, so the kernels'
  scalar arguments never wait on the device.
* paged cache ``{"k_pages"/"v_pages": (Hkv, num_pages + 1, page, D),
  "block_tables": (B, pages) int32, "len": (B,) int32}`` (serve/kv_cache
  layout, the last page a sink) — S=1 decode and S>1 speculative verify
  write their S tokens into the pool in place and attend through the
  block table.  ``len`` is the per-sequence PRE-write fill, a device
  tensor: nothing here reads it back.  Inactive slots (block-table row
  -1) send their writes to the sink and emit zeros.  int8 pools (with
  ``k_scales``/``v_scales``) insert the S tokens one by one, each
  requantizing its page.

The SWA rolling buffer is a later slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (
    apply_rope,
    causal_mask,
    decode_attend,
    dense_apply,
    dense_init,
    flash_attend,
    paged_decode_attend,
    rmsnorm_apply,
    rmsnorm_init,
    softmax_attend,
)
from repro_torch.serve.kv_cache import quant_page_update

# sequences at or above this length attend via the flash path (never
# materialises S x T logits); shorter ones go direct
FLASH_MIN_SEQ = 512


def _paged_token_coords(cache, pool_key, s: int = 1):
    """Where this step's ``s`` tokens land in the pool, per slot.

    Returns (page, slot, new_len): page (B, S) is the pool index at each
    sequence's write positions ``len .. len+s-1`` — inactive slots
    (block-table row -1) and positions past the block table (a
    speculative tail beyond a request's last page) get ``num_pages``,
    the sink page, never a live one; new_len is the post-write fill (0
    stays 0 for inactive slots, which zeroes their attention output).
    All on the device, with no read-back.
    """
    bt, lens = cache["block_tables"], cache["len"]
    leaf = cache[pool_key]
    sink, pg = leaf.shape[1] - 1, leaf.shape[2]
    pos = lens.long()[:, None] + torch.arange(s, device=bt.device)[None, :]  # (B, S)
    idx = torch.clamp(pos // pg, 0, bt.shape[1] - 1)
    page = torch.gather(bt.long(), 1, idx)
    page = torch.where((page < 0) | (pos // pg > bt.shape[1] - 1), sink, page)
    active = bt[:, 0] >= 0
    new_len = torch.where(active, lens + s, 0).to(torch.int32)
    return page, pos % pg, new_len


def gqa_init(gen, cfg, dtype, device):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, dtype, device, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, hkv * hd, dtype, device, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, hkv * hd, dtype, device, bias=cfg.qkv_bias),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def gqa_cache_init(cfg, batch: int, max_len: int, dtype, device):
    t = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, t, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }


def _qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = dense_apply(p["wk"], x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(p, cfg, x, positions, cache=None, *, bidirectional=False):
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)

    if cache is None:
        if s >= FLASH_MIN_SEQ:
            out = flash_attend(q, k, v, window=cfg.sliding_window,
                               bidirectional=bidirectional)
        else:
            mask = (None if bidirectional else
                    causal_mask(s, s, window=cfg.sliding_window, device=x.device))
            out = softmax_attend(q, k, v, mask)
        new_cache = None
    elif "k_pages" in cache:
        # paged decode (S=1) / speculative verify (S>1): write the S
        # tokens into their pool pages in place (one index_put_ per
        # pool; dropped writes land on the sink page), then attend
        # through the block table, O(own kv_len) per sequence
        kp, vp = cache["k_pages"], cache["v_pages"]
        page, slot, new_len = cache.get("coords") or _paged_token_coords(cache, "k_pages", s)
        if kp.dtype == torch.int8:
            # sequential inserts: token j's requant sees tokens < j of its
            # page live, rows past its own slot zeroed
            ksc, vsc = cache["k_scales"], cache["v_scales"]
            for j in range(s):
                quant_page_update(kp, ksc, page[:, j], slot[:, j], k[:, j].transpose(0, 1))
                quant_page_update(vp, vsc, page[:, j], slot[:, j], v[:, j].transpose(0, 1))
            out = paged_decode_attend(q, kp, vp, cache["block_tables"], new_len,
                                      window=cfg.sliding_window, k_scales=ksc,
                                      v_scales=vsc)
            new_cache = {"k_pages": kp, "v_pages": vp, "k_scales": ksc, "v_scales": vsc}
        else:
            kp[:, page, slot] = k.permute(2, 0, 1, 3).to(kp.dtype)
            vp[:, page, slot] = v.permute(2, 0, 1, 3).to(vp.dtype)
            out = paged_decode_attend(q, kp, vp, cache["block_tables"], new_len,
                                      window=cfg.sliding_window)
            new_cache = {"k_pages": kp, "v_pages": vp}
    else:
        t = cache["k"].shape[1]
        cur = cache["len"]
        if cfg.sliding_window and t <= cfg.sliding_window:
            raise NotImplementedError(
                "SWA rolling-buffer cache: ROADMAP.md queue 1, item 8")
        if cur + s > t:
            # the reference's dynamic_update_slice would clamp the write
            # start; the port refuses instead of writing elsewhere
            raise ValueError(f"cache overflow: len {cur} + {s} new rows > {t}")
        # written in place by slice assignment (the reference returns a
        # new buffer from dynamic_update_slice); the caller's dict keeps
        # pointing at the same, now updated, tensors
        ck, cv = cache["k"], cache["v"]
        ck[:, cur:cur + s] = k
        cv[:, cur:cur + s] = v
        new_len = cur + s
        if s == 1:
            # decode: split-KV kernel, O(kv_len) not O(max_len)
            out = decode_attend(q, ck, cv, kv_len=new_len,
                                window=cfg.sliding_window)
        elif s >= FLASH_MIN_SEQ:
            out = flash_attend(q, ck, cv, q_offset=cur,
                               window=cfg.sliding_window, kv_len=new_len)
        else:
            kv_pos = torch.arange(t, device=x.device)
            q_pos = torch.arange(s, device=x.device) + cur
            mask = kv_pos[None, :] <= q_pos[:, None]
            mask &= (kv_pos < new_len)[None, :]
            if cfg.sliding_window:
                mask &= kv_pos[None, :] > (q_pos[:, None] - cfg.sliding_window)
            out = softmax_attend(q, ck, cv, mask)
        new_cache = {"k": ck, "v": cv, "len": new_len}

    y = dense_apply(p["wo"], out.reshape(b, s, -1))
    return y, new_cache
