"""The transformer MoE model in plain float32 PyTorch: RMS norm, rotary
attention (causal, optional window, grouped kv heads), a top-k MoE layer
with GShard capacity (every token's first choice before any second one;
positions past the capacity dropped), the cross-entropy plus the
Switch load-balancing loss, and AdamW.  It follows the configuration's
``model`` dict and the weights of ``yardstick.weights`` by name.

``Prec`` picks the precision the model computes in: float32 (TF32 off;
nothing rounded), or, as the program holds its compute tensors in bf16,
every matrix product's operands and output and every activation the
program keeps in its compute dtype rounded, forward and backward, to
fp8 (e4m3 under a per-tensor scale) or int8 (per-tensor scale), the
precisions below the configuration's bf16 (the controls), or to bf16
(the witness of what bf16 rounding alone does to the reference).

``Routing`` lets a training step route by expert choices made elsewhere
(the program's, or a control's) and judges each choice by the router
logits the reference computes itself, so that rounding which flips a
near-tie does not move the gradients compared.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def _q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _q_int8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to int8 under a per-tensor scale, back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(t / s).clamp(-127, 127) * s


def _round(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fp8":
        return _q8(t)
    if kind == "int8":
        return _q_int8(t)
    if kind == "bf16":
        return t.to(torch.bfloat16).to(torch.float32)
    return t


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _round(x, kind)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind), None


class _MM(torch.autograd.Function):
    """a @ b with rounded operands (and output, unless ``out`` is False),
    the backward's products rounded alike."""

    @staticmethod
    def forward(ctx, a, b, kind, out):
        a, b = _round(a, kind), _round(b, kind)
        ctx.save_for_backward(a, b)
        ctx.kind = kind
        y = a @ b
        return _round(y, kind) if out else y

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        k = ctx.kind
        g = _round(g, k)
        return (_round(g @ b.transpose(-1, -2), k),
                _round(a.transpose(-1, -2) @ g, k), None, None)


class Prec:
    """The compute precision: "fp32", "fp8", "int8" or "bf16"."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8", "int8", "bf16"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def mm(self, a, b, out: bool = True):
        """a @ b; ``out`` False keeps the product in float32 (the router's
        logits, which the program accumulates and keeps in float32)."""
        if self.kind == "fp32":
            return a @ b
        return _MM.apply(a, b, self.kind, out)

    def act(self, x):
        """An activation held in the compute precision."""
        return x if self.kind == "fp32" else _Round.apply(x, self.kind)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def capacity(n_tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    """Per-expert buffer rows: int(T k cf / E) + 1, up to a multiple of 8,
    at least 8."""
    c = int(n_tokens * top_k * cf / n_experts) + 1
    return max(8, -(-c // 8) * 8)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x [B, S, H, hd], rotated by position (halves, not interleaved)."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, wq, wk, wv, wo, m: dict, prec: Prec, head_block: int = 0):
    """h [B, S, d] -> [B, S, d]; ``head_block`` > 0 computes that many
    query heads at a time (memory)."""
    b, s, d = h.shape
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // nh
    theta = m.get("rope_theta", 10_000.0)
    q = prec.act(rope(prec.mm(h, wq).reshape(b, s, nh, hd), theta))
    k = prec.act(rope(prec.mm(h, wk).reshape(b, s, nkv, hd), theta))
    v = prec.mm(h, wv).reshape(b, s, nkv, hd)
    pos = torch.arange(s, device=h.device)
    keep = pos[None, :] <= pos[:, None] if m.get("causal", True) else \
        torch.ones((s, s), dtype=torch.bool, device=h.device)
    if m.get("sliding_window"):
        keep = keep & (pos[None, :] > pos[:, None] - m["sliding_window"])
    rep = nh // nkv
    step = head_block or nh
    outs = []
    for h0 in range(0, nh, step):
        hs = range(h0, min(nh, h0 + step))
        qh = q[:, :, h0:hs[-1] + 1].transpose(1, 2)             # [B, h, S, hd]
        kv_ids = torch.tensor([i // rep for i in hs], device=h.device)
        kh = k.index_select(2, kv_ids).transpose(1, 2)
        vh = v.index_select(2, kv_ids).transpose(1, 2)
        logits = prec.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        logits = logits.masked_fill(~keep, -1e30)
        outs.append(prec.mm(prec.act(torch.softmax(logits, -1)), vh))
    o = torch.cat(outs, 1).transpose(1, 2).reshape(b, s, nh * hd)
    return prec.mm(o, wo)


def first_max_topk(p, k: int):
    """Top-k by iterated first-max argmax (ties to the lower index)."""
    vals, ids = [], []
    for _ in range(k):
        arg = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(p, -1, arg))
        ids.append(arg)
        p = p.scatter(-1, arg, float("-inf"))
    return torch.cat(vals, -1), torch.cat(ids, -1)


class Routing:
    """The expert choices of one training step, layer by layer.

    With ``forced`` (a [T, k] tensor of choices a layer, made elsewhere)
    each layer routes by those choices, first choices before second ones
    for the capacity as the model's own; ``gap`` is the widest gap by
    which a forced choice's router logit lies below the logit of the
    expert the reference ranks at that place (infinite where the
    choices are not [T, k] distinct experts, and the layer then routes
    by its own), and ``flips`` counts the choices that differ from the
    reference's own.  Without it each layer routes by its own top-k,
    kept in ``chosen``."""

    def __init__(self, forced=None):
        self.forced = forced
        self.chosen: dict = {}
        self.gap = 0.0
        self.flips = 0
        self._judged: set = set()

    def take(self, layer: int, logits, own):
        if self.forced is None:
            self.chosen.setdefault(layer, own.detach().to(torch.int32))
            return own
        f = self.forced[layer] if layer < len(self.forced) else None
        f = own.new_full((0,), -1) if f is None else f.to(own.device).long()
        e, k = logits.shape[-1], own.shape[-1]
        valid = f.shape == own.shape and bool(((f >= 0) & (f < e)).all())
        if valid:
            s = torch.sort(f, -1).values
            valid = bool((s[:, 1:] != s[:, :-1]).all())
        first = layer not in self._judged        # not the remat recompute
        self._judged.add(layer)
        if not valid:
            self.gap = math.inf
            return own
        if first:
            with torch.no_grad():
                lg = logits.detach().float()
                ranked = torch.topk(lg, k, dim=-1).values
                mine = torch.gather(lg, -1, f)
                self.gap = max(self.gap,
                               float((ranked - mine).clamp(min=0).amax()))
                self.flips += int((f != own).sum())
        return f


def route(h2, router, top_k: int, cap: int, prec: Prec,
          routing: Routing | None = None, layer: int = 0):
    """Gating of [T, d] tokens: (expert ids [T, k], combine weights [T, k]
    zero where dropped, kept [T, k] bool, probs [T, E]); by ``routing``'s
    choices where it has them."""
    logits = prec.mm(h2, router, out=False)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = first_max_topk(probs, top_k)
    if routing is not None:
        idx = routing.take(layer, logits, idx)
        vals = torch.gather(probs, -1, idx)
    w = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    e = probs.shape[-1]
    onehot = (idx[..., None] == torch.arange(e, device=h2.device)).long()
    flat = onehot.transpose(0, 1).reshape(-1, e)           # choice-major
    pos = (torch.cumsum(flat, 0) - flat).reshape(top_k, -1, e)
    position = (pos.transpose(0, 1) * onehot).sum(-1)
    kept = position < cap
    return idx, w * kept, kept, probs


def aux_loss(idx, probs, weight: float):
    """Switch's E * sum_e f_e p_e, f_e from the top-1 choices."""
    e = probs.shape[-1]
    f = (idx[:, :1] == torch.arange(e, device=idx.device)).float().mean(0)
    return weight * e * torch.sum(f * probs.mean(0))


def expert(x, wi, wu, wo, act: str, prec: Prec):
    h = prec.mm(x, wi)
    h = F.silu(h) * prec.mm(x, wu) if act == "swiglu" else \
        F.gelu(h, approximate="tanh")
    return prec.mm(prec.act(h), wo)


def moe(h2, idx, w, kept, wi, wu, wo, act: str, prec: Prec, rows=None):
    """The experts' weighted sum for the tokens ``rows`` (all by default)
    of h2 [T, d] -> [len(rows), d]."""
    if rows is not None:
        h2, idx, w, kept = h2[rows], idx[rows], w[rows], kept[rows]
    y = torch.zeros_like(h2)
    for e in range(wi.shape[0]):
        tok, ch = torch.nonzero((idx == e) & kept, as_tuple=True)
        if tok.numel():
            out = expert(h2[tok], wi[e], None if wu is None else wu[e],
                         wo[e], act, prec)
            y = y.index_add(0, tok, out * w[tok, ch, None])
    return prec.act(y)


def _layer(x, W: dict, l: int, m: dict, prec: Prec, routing=None):
    """One training block: (x, aux)."""
    eps, moe_c = m.get("norm_eps", 1e-5), m["moe"]
    b, s, d = x.shape
    h = prec.act(rms_norm(x, W["ln1"][l, 0], eps))
    x = prec.act(x + attention(h, W["attn.wq"][l, 0], W["attn.wk"][l, 0],
                               W["attn.wv"][l, 0], W["attn.wo"][l, 0], m,
                               prec))
    h2 = prec.act(rms_norm(x, W["ln2"][l, 0], eps)).reshape(b * s, d)
    cap = capacity(b * s, moe_c["n_experts"], moe_c["top_k"],
                   moe_c["capacity_factor"])
    idx, w, kept, probs = route(h2, W["moe.router"][l], moe_c["top_k"], cap,
                                prec, routing, l)
    wu = W["moe.wu"][l] if "moe.wu" in W else None
    y = moe(h2, idx, w, kept, W["moe.wi"][l], wu, W["moe.wo"][l],
            m.get("ffn_type", "swiglu"), prec)
    aux = aux_loss(idx, probs, moe_c.get("aux_loss_weight", 0.01))
    return prec.act(x + y.reshape(b, s, d)), aux


def unembed(W: dict):
    """The output head [d, V]: the embedding's transpose where tied."""
    return W["lm_head"] if "lm_head" in W else W["embed"].T


def train_loss(W: dict, batch: dict, m: dict, prec: Prec,
               routing: Routing | None = None):
    """Mean next-token cross-entropy plus every layer's aux loss; each
    layer recomputed in the backward (memory); routed by ``routing``."""
    x = prec.act(W["embed"][batch["tokens"].long()])
    aux = torch.zeros((), device=x.device)
    for l in range(m["n_layers"]):
        x, a = checkpoint(_layer, x, W, l, m, prec, routing,
                          use_reentrant=False)
        aux = aux + a
    x = prec.act(rms_norm(x, W["final_norm"], m.get("norm_eps", 1e-5)))
    b, s, d = x.shape
    labels = batch["labels"].long().reshape(-1)
    x = x.reshape(b * s, d)
    tot = torch.zeros((), device=x.device)
    for i in range(0, b * s, 4096):
        def ce(xc, lab):
            logits = prec.mm(xc, unembed(W))
            return (torch.logsumexp(logits, -1)
                    - logits.gather(-1, lab[:, None])[:, 0]).sum()
        tot = tot + checkpoint(ce, x[i:i + 4096], labels[i:i + 4096],
                               use_reentrant=False)
    return tot / (b * s) + aux


class AdamW:
    """AdamW with linear warm-up and cosine decay, global-norm clipping,
    float32 state; ``opt`` holds lr, betas, eps, weight_decay, grad_clip,
    warmup_steps, total_steps."""

    def __init__(self, params: dict, opt: dict):
        self.o = opt
        self.step = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def lr(self) -> float:
        o, s = self.o, float(self.step)
        warm = min(s / max(o["warmup_steps"], 1), 1.0)
        t = min(max((s - o["warmup_steps"])
                    / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
        return o["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * t))

    def update(self, params: dict, grads: dict) -> dict:
        """Clipped grads (as the moments get them); updates ``params``."""
        o = self.o
        gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(o["grad_clip"] / gn.clamp(min=1e-9), max=1.0)
        self.step += 1
        lr = self.lr()
        b1, b2 = o["betas"]
        bc1, bc2 = 1.0 - b1 ** self.step, 1.0 - b2 ** self.step
        clipped = {}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * scale
                clipped[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                             + o["eps"]) \
                    + o["weight_decay"] * p
                p.sub_(lr * delta)
        return clipped


def prefill_last_logits(W: dict, m: dict, tokens, lengths, top_k: int,
                        prec: Prec, head_block: int = 8):
    """The served batch tokens [B, S] (rows right-padded, ``lengths``
    valid; rows of length 0 pad the batch) -> float32 logits of the last
    valid token of each row that has one [B_real, V].  The capacity is
    sized from the valid tokens; padding tokens and rows take buffer
    positions as any token (every token's first choice before any second
    one, in flat order).  The last layer's experts run on the rows' last
    tokens alone (no other token's output reaches the logits)."""
    eps, moe_c = m.get("norm_eps", 1e-5), m["moe"]
    b, s = tokens.shape
    d = m["d_model"]
    x = prec.act(W["embed"][tokens.long()])
    cap = capacity(int(lengths.sum()), moe_c["n_experts"], top_k,
                   moe_c["capacity_factor"])
    last = (torch.arange(b, device=x.device) * s + lengths.long()
            - 1)[lengths > 0]
    for l in range(m["n_layers"]):
        h = prec.act(rms_norm(x, W["ln1"][l, 0], eps))
        for r in range(b):                       # a row at a time (memory)
            x[r:r + 1] = prec.act(x[r:r + 1] + attention(
                h[r:r + 1], W["attn.wq"][l, 0], W["attn.wk"][l, 0],
                W["attn.wv"][l, 0], W["attn.wo"][l, 0], m, prec, head_block))
        del h
        h2 = prec.act(rms_norm(x, W["ln2"][l, 0], eps)).reshape(b * s, d)
        idx, w, kept, _ = route(h2, W["moe.router"][l], top_k, cap, prec)
        wu = W["moe.wu"][l] if "moe.wu" in W else None
        act = m.get("ffn_type", "swiglu")
        xf = x.view(b * s, d)
        if l < m["n_layers"] - 1:
            xf.copy_(prec.act(xf + moe(h2, idx, w, kept, W["moe.wi"][l], wu,
                                       W["moe.wo"][l], act, prec)))
        else:
            xf[last] = prec.act(xf[last] + moe(h2, idx, w, kept,
                                               W["moe.wi"][l], wu,
                                               W["moe.wo"][l], act, prec,
                                               rows=last))
        del h2
    xl = prec.act(rms_norm(x.view(b * s, d)[last], W["final_norm"], eps))
    return prec.mm(xl, unembed(W))
