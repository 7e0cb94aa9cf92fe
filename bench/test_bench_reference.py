"""The reference against the port's route at each configuration's test
size, both in float32 on the CPU: the training loss and gradients, one
AdamW update, and the served batch's last-token logits with padded rows
and the capacity's drops."""
import numpy as np
import pytest
import torch

from bench import harness as H
from bench.reference import transformer as ref
from bench.smoke import smoke_cell
from bench.yardstick import traffic as TR
from bench.yardstick import weights as WT

CPU = torch.device("cpu")


def _program(cell):
    cfg = H.port_config(cell.model, cell.config["port_config"])
    W = WT.make(cell.model, 7, CPU)
    return cfg, W, H.program_params(cfg, {k: v.clone() for k, v in W.items()})


def test_train_loss_and_gradients_match():
    from repro_torch.models import lm as lm_mod
    cell = smoke_cell("gpt2-moe.train", dtype="float32")
    cfg, W, params = _program(cell)
    b = {k: torch.from_numpy(v) for k, v in TR.train_batches(
        cell.model["vocab_size"], cell.traffic, 7, 1)[0].items()}
    ps = {p: t.detach().requires_grad_() for p, t in H.named_leaves(params)}
    tree = H.program_params(cfg, {H.bench_name(p): t for p, t in ps.items()})
    out = lm_mod.forward_train(cfg, tree, b, dispatch_backend="scatter")
    g_prog = torch.autograd.grad(out.loss, list(ps.values()))
    P = {k: v.clone().requires_grad_() for k, v in W.items()}
    loss = ref.train_loss(P, b, cell.model, ref.Prec("fp32"))
    g_ref = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    assert abs(out.loss.item() - loss.item()) <= 1e-5 * abs(loss.item())
    for (p, _), g in zip(ps.items(), g_prog):
        want = g_ref[H.bench_name(p)]
        assert torch.allclose(g, want, rtol=1e-3, atol=1e-6), p


def test_forced_routing_judges_each_choice():
    """Routed by its own choices the reference is unchanged and reads no
    gap; a choice moved to an expert outside the token's top-k reads a gap
    and a flip; choices of the wrong shape read an infinite gap."""
    cell = smoke_cell("gpt2-moe.train", dtype="float32")
    m = cell.model
    W = WT.make(m, 9, CPU)
    b = {k: torch.from_numpy(v) for k, v in TR.train_batches(
        m["vocab_size"], cell.traffic, 9, 1)[0].items()}
    fp = ref.Prec("fp32")
    own = ref.Routing()
    with torch.no_grad():
        base = ref.train_loss(W, b, m, fp, own)
        same = ref.Routing([own.chosen[l] for l in sorted(own.chosen)])
        assert ref.train_loss(W, b, m, fp, same) == base
        assert same.gap == 0.0 and same.flips == 0
        moved = [t.clone() for t in same.forced]
        e = m["moe"]["n_experts"]
        row = moved[1][3]
        row[1] = next(x for x in range(e) if x not in row.tolist())
        alt = ref.Routing(moved)
        ref.train_loss(W, b, m, fp, alt)
        assert alt.gap > 0.0 and alt.flips >= 1
        short = ref.Routing([t[:-1] for t in same.forced])
        ref.train_loss(W, b, m, fp, short)
        assert short.gap == float("inf")


def test_adamw_matches():
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, \
        init_opt_state
    cell = smoke_cell("gpt2-moe.train", dtype="float32")
    o = cell.workload["optimizer"]
    cfg = AdamWConfig(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                      weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                      warmup_steps=o["warmup_steps"],
                      total_steps=o["total_steps"])
    g = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
    gr = [{k: torch.randn(v.shape, generator=g) for k, v in p.items()}
          for _ in range(3)]
    P = {k: v.clone() for k, v in p.items()}
    opt = ref.AdamW(P, o)
    tree = (p["a"], p["b"])
    st = init_opt_state(tree, cfg)
    for gi in gr:
        tree, st, _ = adamw_update(tree, (gi["a"], gi["b"]), st, cfg)
        opt.update(P, gi)
    assert torch.allclose(tree[0], P["a"], rtol=1e-6, atol=1e-9)
    assert torch.allclose(tree[1], P["b"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("lens", [[40, 17, 33], [48, 48, 9, 21]])
def test_prefill_logits_match(lens):
    from repro_torch.core.popularity import PathProfile
    from repro_torch.runtime.server import MoEServer, ServerConfig
    cell = smoke_cell("mixtral-8x22b.prefill", dtype="float32")
    cfg, W, params = _program(cell)
    top_k = cell.workload["server"]["top_k"]
    m = cell.model
    prof = PathProfile(n_layers=m["n_layers"], n_experts=m["moe"]["n_experts"],
                       path_len=3)
    server = MoEServer(cfg, params, prof, ServerConfig(top_k=top_k),
                       device="cpu")
    src = TR.mixture(m["vocab_size"], cell.traffic, 7)
    g = TR.rng(7, 9)
    s, b = max(lens), 1 << (len(lens) - 1).bit_length()
    toks = np.zeros((b, s), np.int64)
    for r, n in enumerate(lens):
        toks[r, :n] = src.draw(g, n)
    lengths = np.zeros(b, np.int64)
    lengths[:len(lens)] = lens
    got = server.serve_batch(toks, lengths=lengths).logits[:len(lens)]
    with torch.no_grad():
        want = ref.prefill_last_logits(
            W, m, torch.from_numpy(toks), torch.from_numpy(lengths), top_k,
            ref.Prec("fp32"))
    assert np.allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)


def test_fp8_control_rounds():
    a = torch.randn(64, 32)
    q = ref._q8(a)
    rel = ((q - a).abs() / a.abs().clamp(min=1e-3)).median()
    assert 1e-3 < rel < 0.1
