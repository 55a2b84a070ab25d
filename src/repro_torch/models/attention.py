"""Attention variants: GQA (+bias / qk-norm / SWA), MLA and the enc-dec
cross-attention (PyTorch port of ``repro.models.attention``).

    params = gqa_init(gen, cfg, dtype, device)      | mla_init(...)
    y, cache = gqa_apply(params, cfg, x, positions, cache=None|dict)
                                                    | mla_apply(...)
    kv = cross_attn_kv(p, cfg, enc_out); y = cross_attn_apply(p, cfg, x, kv)

* ``cache=None`` — full causal (or bidirectional) forward, no state.
* dense cache ``{"k": (B, T, Hkv, D), "v": (B, T, Hkv, Dv), "len": int}``
  — prefill chunks and S=1 decode steps write their K/V at ``len`` and
  attend over the live prefix.  ``len`` is a host int, so the kernels'
  scalar arguments never wait on the device.  An SWA config's buffer
  holds ``T = min(max_len, window)`` rows and rolls: after every call,
  row j holds the key of position ``len - T + j`` (the ordered
  snapshot), so chunked prefill and decode both attend over
  ``[buffer | new]`` and keep the trailing T rows.
* MLA's dense cache ``{"kv": (B, T, r + dr), "len": int}`` is ONE buffer
  of ``[c_kv | k_rope]`` rows (the reference keeps ``ckv`` and ``k_rope``
  apart): the compressed latent and the shared rope key are views of
  it, and the absorbed decode reads it as K with V a view of its leading
  r columns, the layout the dense decode kernel streams fastest.
* paged cache ``{"k_pages"/"v_pages": (Hkv, num_pages + 1, page, D),
  "block_tables": (B, pages) int32, "len": (B,) int32}`` (serve/kv_cache
  layout, the last page a sink; MLA: one ``"kv_pages"`` (1, num_pages +
  1, page, r + dr) pool serving as key and value) — S=1 decode and S>1
  speculative verify write their S tokens into the pool in place and
  attend through the block table.  ``len`` is the per-sequence PRE-write
  fill, a device tensor: nothing here reads it back.  Inactive slots
  (block-table row -1) send their writes to the sink and emit zeros.
  int8 pools (with ``*_scales``) insert the S tokens one by one, each
  requantizing its page.

Tensor parallelism (``dist.tensor``'s ambient model group; the layer's
mode read from its leaves' widths against the config's, never from the
strategy): a ``wq`` holding this rank's query heads runs them alone, its
input through ``copy`` and ``wo`` (split by rows) summed over the ranks.
K / V split on head boundaries give this rank's KV heads; split inside a
head (``kv_heads * head_dim`` over the model size not a multiple of
``head_dim``) they are gathered whole (the ``reduce_scatter`` adjoint) and
each rank reads the KV heads of its own query heads, its cache holding
them all, as ``cache_specs`` leaves the heads dim whole there.  MLA's
``wdkv`` splits across the latent: the latent is gathered before
``ckv_norm``; ``wq`` / ``wuk`` / ``wuv`` split on head boundaries.  A
replicated param used on this rank's heads (``q_norm``, ``k_norm``,
``ckv_norm``, a K/V projection left whole) goes through ``copy``, so its
gradient sums the ranks' shares.  The paged pools stay on one process.
The enc-dec cross-attention splits on head boundaries: ``wq`` / ``wk`` /
``wv`` by columns, ``wo`` by rows, so each rank's cross K/V holds its
heads.
"""

from __future__ import annotations

import torch

from repro_torch.dist import tensor as tp
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
    row_parallel_apply,
    softmax_attend,
    width,
)
from repro_torch.optim.quant import dequant_int8
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


def gqa_cache_init(cfg, batch: int, max_len: int, dtype, device, kv_heads: int | None = None):
    """``kv_heads``: the heads this rank's cache holds (its share under
    tensor parallelism, :func:`cache_kv_heads`); the config's by default."""
    t = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, t, kv_heads or cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }


def cache_kv_heads(p, cfg) -> int:
    """The KV heads a GQA layer's cache holds on this rank: its share where
    ``wk`` splits on head boundaries, else all of them."""
    w = width(p["wk"])
    return w // cfg.head_dim if w % cfg.head_dim == 0 else cfg.kv_heads


def _tp_heads(p, cfg) -> int | None:
    """This rank's query heads under tensor parallelism, or None where
    ``wq`` is whole (the layer computes whole)."""
    w = width(p["wq"])
    if not tp.split(w, cfg.num_heads * cfg.head_dim):
        return None
    if w % cfg.head_dim:
        raise NotImplementedError(f"{cfg.name}: query heads split inside a head")
    return w // cfg.head_dim


def _kv_window(cfg, hq: int, held: int) -> slice | None:
    """The KV heads (of the ``held`` this rank computes) that its ``hq``
    query heads read: all of a share split on head boundaries (None), else
    those of query heads ``rank * hq .. (rank + 1) * hq - 1``."""
    if held != cfg.kv_heads:
        return None
    g = cfg.num_heads // cfg.kv_heads
    first = tp.model_rank() * hq
    return slice(first // g, (first + hq - 1) // g + 1)


def _pick(t, sel):
    """The KV heads ``sel`` of ``t`` (B, T, H, D), in storage of their own."""
    return t if sel is None else t[:, :, sel].contiguous()


def _qkv(p, cfg, x, positions):
    """(q, k, v, hq, window): q this rank's ``hq`` query heads (all without
    tensor parallelism, ``hq`` None), k / v the KV heads it computes,
    ``window`` those its queries read (None: all)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hq = _tp_heads(p, cfg)
    qn, kn, wk, wv = p.get("q_norm"), p.get("k_norm"), p["wk"], p["wv"]
    if hq is not None:
        x = tp.copy(x)
        if cfg.qk_norm:
            qn, kn = tp.copy_tree(qn), tp.copy_tree(kn)
        if width(wk) == cfg.kv_heads * hd:
            # K / V left whole: every rank computes them, reads its heads
            wk, wv = tp.copy_tree(wk), tp.copy_tree(wv)
    q = dense_apply(p["wq"], x).reshape(b, s, hq or cfg.num_heads, hd)
    k, v = dense_apply(wk, x), dense_apply(wv, x)
    if k.shape[-1] % hd:
        # split inside a head: gather K / V whole; each rank reads its own
        k = tp.gather(k, -1, reduce_grad=True)
        v = tp.gather(v, -1, reduce_grad=True)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(qn, q, cfg.norm_eps)
        k = rmsnorm_apply(kn, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = None if hq is None else _kv_window(cfg, hq, k.shape[2])
    return q, k, v, hq, window


def _out(p, hq, out):
    """The output projection: ``wo`` split by rows sums the ranks'."""
    if hq is None:
        return dense_apply(p["wo"], out)
    return row_parallel_apply(p["wo"], out)


def gqa_apply(p, cfg, x, positions, cache=None, *, bidirectional=False):
    b, s, _ = x.shape
    q, k, v, hq, sel = _qkv(p, cfg, x, positions)

    if cache is None:
        k, v = _pick(k, sel), _pick(v, sel)
        if s >= FLASH_MIN_SEQ:
            out = flash_attend(q, k, v, window=cfg.sliding_window,
                               bidirectional=bidirectional)
        else:
            mask = (None if bidirectional else
                    causal_mask(s, s, window=cfg.sliding_window, device=x.device))
            out = softmax_attend(q, k, v, mask)
        new_cache = None
    elif "k_pages" in cache:
        if hq is not None:
            from repro_torch.dist.sharding import MULTI_CARD_ITEM

            raise NotImplementedError(f"the paged pools under tensor parallelism are "
                                      f"{MULTI_CARD_ITEM}")
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
            # SWA rolling buffer (ordered snapshot: row j holds position
            # cur - t + j, negative = not written yet, masked out): attend
            # over [buffer | new keys], then keep the trailing t rows
            full_k = torch.cat([cache["k"], k.to(cache["k"].dtype)], dim=1)
            full_v = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
            kv_pos = cur - t + torch.arange(t + s, device=x.device)
            q_pos = cur + torch.arange(s, device=x.device)
            mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos >= 0)[None, :]
            mask &= kv_pos[None, :] > (q_pos[:, None] - cfg.sliding_window)
            out = softmax_attend(q, _pick(full_k, sel), _pick(full_v, sel), mask)
            ck, cv = cache["k"], cache["v"]
            ck.copy_(full_k[:, s:])
            cv.copy_(full_v[:, s:])
            y = _out(p, hq, out.reshape(b, s, -1))
            return y, {"k": ck, "v": cv, "len": cur + s}
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
        ak, av = _pick(ck, sel), _pick(cv, sel)
        if s == 1:
            # decode: split-KV kernel, O(kv_len) not O(max_len)
            out = decode_attend(q, ak, av, kv_len=new_len,
                                window=cfg.sliding_window)
        elif s >= FLASH_MIN_SEQ:
            out = flash_attend(q, ak, av, q_offset=cur,
                               window=cfg.sliding_window, kv_len=new_len)
        else:
            kv_pos = torch.arange(t, device=x.device)
            q_pos = torch.arange(s, device=x.device) + cur
            mask = kv_pos[None, :] <= q_pos[:, None]
            mask &= (kv_pos < new_len)[None, :]
            if cfg.sliding_window:
                mask &= kv_pos[None, :] > (q_pos[:, None] - cfg.sliding_window)
            out = softmax_attend(q, ak, av, mask)
        new_cache = {"k": ck, "v": cv, "len": new_len}

    y = _out(p, hq, out.reshape(b, s, -1))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2)
# ---------------------------------------------------------------------------


def _w(p):
    """Weight of a dense dict for einsum-shaped uses (MLA's weight
    absorption): a quantized dict gives the f32 dequant of its int8
    ``qw`` (the stored leaf stays int8); a float dict its ``w``."""
    if "qw" in p:
        return dequant_int8(p["qw"], p["qscale"])
    return p["w"]


def mla_init(gen, cfg, dtype, device):
    d, h = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    dn, dv = cfg.mla_head_dim, cfg.mla_v_head_dim
    q_in = cfg.q_lora_rank or d
    p = {
        # queries (nope + rope parts), from the q-lora latent when it is set
        "wq": dense_init(gen, q_in, h * (dn + dr), dtype, device),
        # joint KV down-projection -> [c_kv (r) | k_rope (dr)]
        "wdkv": dense_init(gen, d, r + dr, dtype, device),
        "ckv_norm": rmsnorm_init(r, dtype, device),
        # up-projections from the latent
        "wuk": dense_init(gen, r, h * dn, dtype, device),
        "wuv": dense_init(gen, r, h * dv, dtype, device),
        "wo": dense_init(gen, h * dv, d, dtype, device),
    }
    if cfg.q_lora_rank:
        p["wdq"] = dense_init(gen, d, cfg.q_lora_rank, dtype, device)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, device)
    return p


def mla_cache_init(cfg, batch: int, max_len: int, dtype, device):
    width = cfg.kv_lora_rank + cfg.rope_head_dim
    return {"kv": torch.zeros((batch, max_len, width), dtype=dtype, device=device),
            "len": 0}


def _mla_heads(p, cfg) -> int | None:
    """This rank's MLA heads under tensor parallelism (None: whole)."""
    per = cfg.mla_head_dim + cfg.rope_head_dim
    w = width(p["wq"])
    if not tp.split(w, cfg.num_heads * per):
        return None
    if w % per:
        raise NotImplementedError(f"{cfg.name}: MLA heads split inside a head")
    return w // per


def _latent(p, x, whole: int, tp_on: bool):
    """A down-projection under tensor parallelism: a column slice of the
    latent gathered whole (each rank reads it for its own heads, so the
    gradients' sum is scattered back), a leaf left whole through
    ``copy``."""
    if not tp_on:
        return dense_apply(p, x)
    if width(p) == whole:
        return dense_apply(tp.copy_tree(p), x)
    return tp.gather(dense_apply(p, x), -1, reduce_grad=True)


def _mla_qkv_latent(p, cfg, x, positions):
    b, s, _ = x.shape
    dn, dr = cfg.mla_head_dim, cfg.rope_head_dim
    hl = _mla_heads(p, cfg)
    h, tp_on = hl or cfg.num_heads, hl is not None
    norm_ckv, norm_q = p["ckv_norm"], p.get("q_norm")
    if tp_on:
        x = tp.copy(x)
        norm_ckv = tp.copy_tree(norm_ckv)
        norm_q = norm_q and tp.copy_tree(norm_q)
    xq = x
    if cfg.q_lora_rank:
        xq = rmsnorm_apply(norm_q, _latent(p["wdq"], x, cfg.q_lora_rank, tp_on),
                           cfg.norm_eps)
    q = dense_apply(p["wq"], xq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = _latent(p["wdkv"], x, cfg.kv_lora_rank + dr, tp_on)
    ckv = rmsnorm_apply(norm_ckv, dkv[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_rope = dkv[..., cfg.kv_lora_rank:][:, :, None, :]  # 1 shared head
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_attend(p, cfg, q_nope, q_rope, ckv, k_rope, mask=None, *,
                q_offset: int = 0, kv_len: int | None = None):
    """MLA attention: the latent is up-projected per head; the rope part is
    a single shared head concatenated onto the nope part, so the flash
    path applies unchanged for long sequences (D = dn + dr, Dv = dv)."""
    b, s, h, dn = q_nope.shape
    t = ckv.shape[1]
    dr, dv = cfg.rope_head_dim, cfg.mla_v_head_dim
    k_nope = dense_apply(p["wuk"], ckv).reshape(b, t, h, dn)
    v = dense_apply(p["wuv"], ckv).reshape(b, t, h, dv)
    scale = (dn + dr) ** -0.5

    if s >= FLASH_MIN_SEQ:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, dr)], dim=-1)
        out = flash_attend(q, k, v, q_offset=q_offset, kv_len=kv_len, scale=scale)
        return out.reshape(b, s, h * dv)

    logits = torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
    logits += torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    logits = logits * scale
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.reshape(b, s, h * dv).to(q_nope.dtype)


def _mla_absorbed_q(p, cfg, q_nope, q_rope):
    """Fold ``Wuk`` into the query: latent-space queries (B, S, H, r+dr)."""
    h, dn = q_nope.shape[2], q_nope.shape[3]
    r = cfg.kv_lora_rank
    wuk = _w(p["wuk"]).reshape(r, h, dn).to(q_nope.dtype)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wuk)
    return torch.cat([q_lat, q_rope], dim=-1)


def _mla_up_project(p, cfg, out_lat):
    """Up-project the attended latent through ``Wuv``."""
    b, s, h, r = out_lat.shape
    dv = cfg.mla_v_head_dim
    wuv = _w(p["wuv"]).reshape(r, h, dv).to(out_lat.dtype)
    out = torch.einsum("bshr,rhd->bshd", out_lat, wuv)
    return out.reshape(b, s, h * dv)


def _mla_attend_absorbed(p, cfg, q_nope, q_rope, kv, *, kv_len: int):
    """Decode (S=1) MLA by weight absorption: ``k_nope[t, h] = Wuk[:, h]^T
    c_kv[t]``, so the nope logits are ``(Wuk q_nope) . c_kv`` and the step
    attends in the latent space — keys the cache's ``[c_kv | k_rope]``
    rows, values a view of their leading r columns, one shared KV head —
    and only the attended latent goes through ``Wuv``."""
    dn, dr = cfg.mla_head_dim, cfg.rope_head_dim
    q = _mla_absorbed_q(p, cfg, q_nope, q_rope)
    k = kv[:, :, None, :]
    out_lat = decode_attend(q, k, k[..., :cfg.kv_lora_rank], kv_len=kv_len,
                            scale=(dn + dr) ** -0.5)  # (B, 1, H, r)
    return _mla_up_project(p, cfg, out_lat)


def _mla_attend_absorbed_paged(p, cfg, q_nope, q_rope, pool, block_tables,
                               kv_lens, scales=None):
    """Paged twin of :func:`_mla_attend_absorbed`: pool rows are
    ``[c_kv | k_rope]``, so the pool serves as key AND value pages — ``dv
    = r`` reads the value as each row's leading columns (an int8 pool's
    per-page ``scales`` serve both sides)."""
    dn, dr = cfg.mla_head_dim, cfg.rope_head_dim
    q = _mla_absorbed_q(p, cfg, q_nope, q_rope)
    out_lat = paged_decode_attend(q, pool, pool, block_tables, kv_lens,
                                  scale=(dn + dr) ** -0.5, dv=cfg.kv_lora_rank,
                                  k_scales=scales, v_scales=scales)
    return _mla_up_project(p, cfg, out_lat)


def mla_apply(p, cfg, x, positions, cache=None):
    b, s, _ = x.shape
    r = cfg.kv_lora_rank
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, cfg, x, positions)
    hl = q_nope.shape[2] if q_nope.shape[2] != cfg.num_heads else None
    if cache is None:
        mask = causal_mask(s, s, device=x.device) if s < FLASH_MIN_SEQ else None
        out = _mla_attend(p, cfg, q_nope, q_rope, ckv, k_rope, mask)
        new_cache = None
    elif "kv_pages" in cache:
        if hl is not None:
            from repro_torch.dist.sharding import MULTI_CARD_ITEM

            raise NotImplementedError(f"the paged pools under tensor parallelism are "
                                      f"{MULTI_CARD_ITEM}")
        # paged decode (S=1) / speculative verify (S>1): one [c_kv | k_rope]
        # row per token in the pool
        page, slot, new_len = cache.get("coords") or _paged_token_coords(cache, "kv_pages", s)
        row = torch.cat([ckv, k_rope], dim=-1)  # (B, S, r+dr)
        pool = cache["kv_pages"]
        if pool.dtype == torch.int8:
            sc = cache["kv_scales"]
            for j in range(s):
                quant_page_update(pool, sc, page[:, j], slot[:, j], row[None, :, j])
            out = _mla_attend_absorbed_paged(p, cfg, q_nope, q_rope, pool,
                                             cache["block_tables"], new_len, scales=sc)
            new_cache = {"kv_pages": pool, "kv_scales": sc}
        else:
            pool[0, page, slot] = row.to(pool.dtype)
            out = _mla_attend_absorbed_paged(p, cfg, q_nope, q_rope, pool,
                                             cache["block_tables"], new_len)
            new_cache = {"kv_pages": pool}
    else:
        kv, cur = cache["kv"], cache["len"]
        t = kv.shape[1]
        if cur + s > t:
            raise ValueError(f"cache overflow: len {cur} + {s} new rows > {t}")
        # written in place, as the GQA cache; c_kv and k_rope are views
        kv[:, cur:cur + s] = torch.cat([ckv, k_rope], dim=-1).to(kv.dtype)
        new_len = cur + s
        cc, cr = kv[..., :r], kv[..., r:]
        if s == 1:
            # decode: weight-absorbed split-KV over the compressed cache
            out = _mla_attend_absorbed(p, cfg, q_nope, q_rope, kv, kv_len=new_len)
        elif s >= FLASH_MIN_SEQ:
            out = _mla_attend(p, cfg, q_nope, q_rope, cc, cr, q_offset=cur,
                              kv_len=new_len)
        else:
            kv_pos = torch.arange(t, device=x.device)
            q_pos = torch.arange(s, device=x.device) + cur
            mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos < new_len)[None, :]
            out = _mla_attend(p, cfg, q_nope, q_rope, cc, cr, mask)
        new_cache = {"kv": kv, "len": new_len}
    return _out(p, hl, out), new_cache


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec decoder blocks)
# ---------------------------------------------------------------------------


def cross_attn_init(gen, cfg, dtype, device):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, h * hd, dtype, device),
        "wv": dense_init(gen, d, h * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }


def _cross_heads(p, cfg, key: str) -> int | None:
    """This rank's cross-attention heads from ``p[key]``'s width, or None
    where it is whole."""
    w = width(p[key])
    if not tp.split(w, cfg.num_heads * cfg.head_dim):
        return None
    if w % cfg.head_dim:
        raise NotImplementedError(f"{cfg.name}: cross-attention heads split inside a head")
    return w // cfg.head_dim


def cross_attn_kv(p, cfg, enc_out):
    """Encoder K/V, computed once per request (the enc-dec 'cache'):
    (B, T, H, D) each, ``num_heads`` heads (this rank's under tensor
    parallelism)."""
    b, t, _ = enc_out.shape
    if _cross_heads(p, cfg, "wk") is not None:
        enc_out = tp.copy(enc_out)
    k = dense_apply(p["wk"], enc_out).reshape(b, t, -1, cfg.head_dim)
    v = dense_apply(p["wv"], enc_out).reshape(b, t, -1, cfg.head_dim)
    return {"k": k, "v": v}


def cross_attn_apply(p, cfg, x, kv):
    """Bidirectional attention of ``x`` (B, S, D) over the encoder K/V.  As
    the reference, flash runs whenever S or T reaches FLASH_MIN_SEQ, a
    decode step's single query row against a long encoder output too."""
    b, s, _ = x.shape
    hq = _cross_heads(p, cfg, "wq")
    if hq is not None:
        x = tp.copy(x)
    q = dense_apply(p["wq"], x).reshape(b, s, hq or cfg.num_heads, cfg.head_dim)
    if kv["k"].shape[2] != q.shape[2]:
        raise ValueError(f"cross K/V of {kv['k'].shape[2]} heads for {q.shape[2]} query heads")
    t = kv["k"].shape[1]
    if s >= FLASH_MIN_SEQ or t >= FLASH_MIN_SEQ:
        out = flash_attend(q, kv["k"], kv["v"], bidirectional=True)
    else:
        out = softmax_attend(q, kv["k"], kv["v"])
    return _out(p, hq, out.reshape(b, s, -1))
