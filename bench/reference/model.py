"""The split language model in plain PyTorch, for the benchmark's check.

Written from the configuration's equations, not from the program: a
llama-style decoder (RMSNorm, rotary embedding on the first and second
halves of each head, grouped-query causal attention, a gated-SiLU MLP)
and, for a mixture of experts, top-k routing over the experts with the
renormalised gates, a per-expert capacity of
``max(4, round_up_4(int(capacity_factor * S * k / E)))`` assignments per
example (counted in token-major, then top-k order; later ones are
dropped) and the Switch load-balance loss
``coef * E * sum_e(share of assignments_e * mean router probability_e)``.

The two parties: Party A embeds its own token stream and runs its tower;
its output Z_A is the cut tensor.  Party B embeds the tokens, runs its
bottom tower, adds ``Z_A @ fuse_proj``, runs its top tower, a final
RMSNorm and the head; the loss of an instance is the mean over its
positions of ``logsumexp(logits) - logits[label]`` over the unpadded
vocabulary.  Party B's objective adds the load-balance loss of its own
layers.

Everything is computed in the weights' dtype: fp32, with TF32 off, is the
reference; bf16 throughout (norms, softmax, routing, logits and the
optimizer's state too) is the check's control.  Every product goes
through a :class:`Products` object: ``fp8`` rounds both operands of every
product (and the gradient that flows back into it) to float8 with one
scale a tensor, a second, lower control.  Activations are recomputed layer by layer in
the backward (``torch.utils.checkpoint``), so a full-width model fits
beside its optimizer state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``top``, back in fp32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3 and the incoming gradient in
    e5m2, as float8 training runs a product; sums in fp32."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # a weight shared over leading dims sums their gradients
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class Products:
    """The precision of every product: ``fp32`` or ``fp8``."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"products: fp32 or fp8, got {kind!r}")
        self.kind = kind

    def mm(self, a, b):
        if self.kind == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)


def rmsnorm(scale, x, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0..S-1; the first half of each head
    rotates against the second."""
    S, hd = x.shape[1], x.shape[3]
    half = hd // 2
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device),
                            torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(p, x, cfg: dict, pr: Products):
    B, S, d = x.shape
    H, Kv, hd = cfg["H"], cfg["Kv"], cfg["hd"]
    q = pr.mm(x, p["wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = pr.mm(x, p["wk"].reshape(d, Kv * hd)).reshape(B, S, Kv, hd)
    v = pr.mm(x, p["wv"].reshape(d, Kv * hd)).reshape(B, S, Kv, hd)
    q, k = rope(q, cfg["theta"]), rope(k, cfg["theta"])
    k = k.repeat_interleave(H // Kv, dim=2)
    v = v.repeat_interleave(H // Kv, dim=2)
    s = pr.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    pos = torch.arange(S, device=x.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], NEG)
    o = pr.mm(torch.softmax(s, dim=-1), v.transpose(1, 2))   # (B,H,S,hd)
    return pr.mm(o.transpose(1, 2).reshape(B, S, H * hd),
                 p["wo"].reshape(H * hd, d))


def mlp(p, x, pr: Products):
    return pr.mm(F.silu(pr.mm(x, p["wg"])) * pr.mm(x, p["wu"]), p["wd"])


def capacity(S: int, cfg: dict) -> int:
    c = int(cfg["capacity_factor"] * S * cfg["top_k"] / cfg["E"])
    return max(4, (c + 3) // 4 * 4)


def moe(p, x, cfg: dict, pr: Products):
    """-> (y, load-balance loss)."""
    B, S, d = x.shape
    E, k = cfg["E"], cfg["top_k"]
    logits = pr.mm(x, p["router"])                          # (B, S, E)
    order = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
    idx = order[..., :k]                                    # (B, S, k)
    gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    flat = idx.reshape(B, S * k)
    onehot = F.one_hot(flat, E)                             # (B, S·k, E)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(-1, flat[..., None])[..., 0]
    keep = pos < capacity(S, cfg)
    tok = (torch.arange(B, device=x.device)[:, None] * S
           + torch.arange(S * k, device=x.device)[None, :] // k)
    # the kept assignments grouped by expert (a dropped one sorts last,
    # as expert E); one read of the counts on the host
    expert = torch.where(keep, flat, E).reshape(-1)
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=E + 1).tolist()
    rows = tok.reshape(-1)[order]
    g = gates.reshape(-1)[order]
    xf = x.reshape(B * S, d)
    outs, start = [], 0
    for e in range(E):
        r = rows[start:start + counts[e]]
        start += counts[e]
        if counts[e]:
            pe = {"wg": p["wg"][e], "wu": p["wu"][e], "wd": p["wd"][e]}
            outs.append(mlp(pe, xf[r], pr))
    n = start
    y = torch.zeros((B * S, d), dtype=x.dtype, device=x.device).index_add(
        0, rows[:n], torch.cat(outs) * g[:n, None])
    share = onehot.float().mean(dim=(0, 1))
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    aux = cfg["aux_coef"] * E * torch.sum(share * mean_prob)
    return y.reshape(B, S, d), aux


def block(p, x, cfg: dict, pr: Products):
    x = x + attention(p["attn"], rmsnorm(p["ln1"]["scale"], x, cfg["eps"]),
                      cfg, pr)
    h = rmsnorm(p["ln2"]["scale"], x, cfg["eps"])
    if cfg["E"]:
        y, aux = moe(p["ffn"], h, cfg, pr)
    else:
        y, aux = mlp(p["ffn"], h, pr), x.new_zeros(())
    return x + y, aux


def tower(stage, x, cfg: dict, pr: Products):
    """A stage of stacked blocks -> (x, summed load-balance loss)."""
    aux = x.new_zeros(())
    L = stage["b0"]["ln1"]["scale"].shape[0]
    for li in range(L):
        p = _layer(stage["b0"], li)
        if torch.is_grad_enabled():
            x, a = checkpoint(block, p, x, cfg, pr, use_reentrant=False)
        else:
            x, a = block(p, x, cfg, pr)
        aux = aux + a
    return x, aux


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def forward_a(pa, cfg: dict, batch_a, pr: Products):
    x = pa["embed"][batch_a["tokens_a"]]
    x, _ = tower(pa["tower"][0], x, cfg, pr)
    return x


def loss_b(pb, cfg: dict, z, batch_b, pr: Products,
           keep: Optional[float] = None):
    """-> (per-instance loss (B,), load-balance loss).  ``keep`` < 1 takes
    the mean over only that leading share of the batch's tokens (a fault
    the check is shown to catch)."""
    x = pb["embed"][batch_b["tokens"]]
    x, aux1 = tower(pb["bottom"][0], x, cfg, pr)
    x = x + pr.mm(z, pb["fuse_proj"])
    x, aux2 = tower(pb["top"][0], x, cfg, pr)
    h = rmsnorm(pb["ln_f"]["scale"], x, cfg["eps"])
    logits = pr.mm(h, pb["head"][:, :cfg["vocab"]])
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, batch_b["labels"][..., None])[..., 0]
    if keep is not None and keep < 1.0:
        B, S = nll.shape
        n = int(B * S * keep)
        mask = (torch.arange(B * S, device=nll.device) < n).reshape(B, S)
        return (nll * mask).sum(-1) * (B / n), aux1 + aux2
    return nll.mean(dim=-1), aux1 + aux2


def model_cfg(config: dict) -> dict:
    """The sizes the reference reads, from a configuration file."""
    port = config["port"]
    d = config["hidden_size"]
    H = config["num_attention_heads"]
    return {
        "d": d, "H": H, "Kv": config["num_key_value_heads"],
        "hd": config.get("head_dim") or d // H,
        "vocab": config["vocab_size"],
        "theta": float(config["rope_theta"]),
        "eps": float(config["rms_norm_eps"]),
        "E": config.get("num_local_experts", 0),
        "top_k": config.get("num_experts_per_tok", 0),
        "capacity_factor": port.get("capacity_factor", 1.25),
        "aux_coef": port.get("router_aux_coef", 0.0),
    }
