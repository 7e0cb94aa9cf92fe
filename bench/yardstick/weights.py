"""The benchmark's weights: made on the device from the seed, in one
``torch.randn`` over every random leaf and a few in-place scalings, and
handed to both the program and the reference by name.

Distributions: N(0, 1/fan_in) for projections (fan-in the second-to-last
dim), N(0, 1/d) for the embedding, ones for the norms.  Leaves are the
transformer MoE stack's, stacked over the layers ([L, 1, ...] for the
attention and norms: one block a layer group); with ``tie_embeddings``
the output head is the embedding's transpose and has no leaf of its
own."""
from __future__ import annotations

import torch


def leaf_specs(m: dict) -> list:
    """[(name, shape, kind)] in draw order; kind is the fan-in axis of a
    random leaf, or "ones"."""
    d, v, L = m["d_model"], m["vocab_size"], m["n_layers"]
    hd = m.get("head_dim") or d // m["n_heads"]
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    moe = m["moe"]
    e, f = moe["n_experts"], moe.get("d_ff") or m["d_ff"]
    out = [("embed", (v, d), -1),
           ("attn.wq", (L, 1, d, hq), -2), ("attn.wk", (L, 1, d, hkv), -2),
           ("attn.wv", (L, 1, d, hkv), -2), ("attn.wo", (L, 1, hq, d), -2),
           ("ln1", (L, 1, d), "ones"), ("ln2", (L, 1, d), "ones"),
           ("moe.router", (L, d, e), -2), ("moe.wi", (L, e, d, f), -2)]
    if m.get("ffn_type", "swiglu") == "swiglu":
        out.append(("moe.wu", (L, e, d, f), -2))
    out += [("moe.wo", (L, e, f, d), -2), ("final_norm", (d,), "ones")]
    if not m.get("tie_embeddings"):
        out.append(("lm_head", (d, v), -2))
    return out


def make(m: dict, seed: int, device) -> dict:
    """{name: float32 tensor} on ``device``; the random leaves are views of
    one buffer."""
    specs = leaf_specs(m)
    n = sum(_numel(s) for _, s, k in specs if k != "ones")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        k = _numel(shape)
        out[name] = flat[at:at + k].view(shape).mul_(shape[kind] ** -0.5)
        at += k
    return out


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= s
    return k
