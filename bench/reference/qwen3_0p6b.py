"""Plain float32 reference of Qwen3 (``model_type`` "qwen3"): a decoder of
RMSNorm, grouped-query attention with a per-head RMSNorm on queries and
keys and rotary positions, and a SiLU-gated MLP; the head tied to the
embedding where ``tie_word_embeddings`` says so.  It reads the published
key names of the configuration file and the weights the benchmark made;
it imports nothing of the program.

``layout(c)`` lists the weights as ``(path, shape, std)``: ``std`` the
normal's deviation, None for a norm's scale.  ``score(w, c, tokens,
first)`` gives the logits that predict each token after position
``first - 1`` (rows ``first .. T - 1`` of the forward over ``tokens``).
"""

from __future__ import annotations

import torch

from bench.reference._plain import causal_attention, gated_mlp, matmul, rmsnorm, rope


def layout(c: dict) -> list:
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    out = [(("embed", "table"), (v, d), 0.02)]
    for i in range(c["num_hidden_layers"]):
        b = ("blocks", i)
        out += [
            (b + ("norm1", "scale"), (d,), None),
            (b + ("mixer", "wq", "w"), (d, h * hd), d ** -0.5),
            (b + ("mixer", "wk", "w"), (d, hkv * hd), d ** -0.5),
            (b + ("mixer", "wv", "w"), (d, hkv * hd), d ** -0.5),
            (b + ("mixer", "wo", "w"), (h * hd, d), (h * hd) ** -0.5),
            (b + ("mixer", "q_norm", "scale"), (hd,), None),
            (b + ("mixer", "k_norm", "scale"), (hd,), None),
            (b + ("norm2", "scale"), (d,), None),
            (b + ("ffn", "w_gate", "w"), (d, f), d ** -0.5),
            (b + ("ffn", "w_up", "w"), (d, f), d ** -0.5),
            (b + ("ffn", "w_down", "w"), (f, d), f ** -0.5),
        ]
    out.append((("final_norm", "scale"), (d,), None))
    if not c["tie_word_embeddings"]:
        out.append((("lm_head", "w"), (d, v), d ** -0.5))
    return out


def _attention(p, c, x, pos):
    t = x.shape[0]
    h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    eps = c["rms_norm_eps"]
    q = matmul(x, p["wq"]["w"]).reshape(t, h, hd)
    k = matmul(x, p["wk"]["w"]).reshape(t, hkv, hd)
    v = matmul(x, p["wv"]["w"]).reshape(t, hkv, hd)
    q = rope(rmsnorm(q, p["q_norm"]["scale"], eps), pos, c["rope_theta"])
    k = rope(rmsnorm(k, p["k_norm"]["scale"], eps), pos, c["rope_theta"])
    g = h // hkv
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    o = causal_attention(q, k, v, hd ** -0.5)
    return matmul(o.reshape(t, h * hd), p["wo"]["w"])


@torch.no_grad()
def score(w, c: dict, tokens: torch.Tensor, first: int) -> torch.Tensor:
    if c.get("rope_scaling") or c.get("use_sliding_window") or c.get("attention_bias"):
        raise NotImplementedError("rope scaling, sliding windows and attention biases "
                                  "are not in this reference")
    eps = c["rms_norm_eps"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = w["embed"]["table"][tokens].float()
    for p in w["blocks"]:
        x = x + _attention(p["mixer"], c, rmsnorm(x, p["norm1"]["scale"], eps), pos)
        m = p["ffn"]
        x = x + gated_mlp(rmsnorm(x, p["norm2"]["scale"], eps),
                          m["w_gate"]["w"], m["w_up"]["w"], m["w_down"]["w"])
    x = rmsnorm(x[first:], w["final_norm"]["scale"], eps)
    if c["tie_word_embeddings"]:
        return matmul(x, w["embed"]["table"].T)
    return matmul(x, w["lm_head"]["w"])
