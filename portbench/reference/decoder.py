"""Plain float32 reference of the served decoders, and its float8 control.

A straight forward pass over each request's own tokens (no padding, no
cache, no batching across requests), written from the configuration file's
keys alone: token embedding, then per layer a pre-norm (LayerNorm with
bias, or RMSNorm as x / rms(x) * (1 + scale)), multi-head attention with
grouped K/V heads, RoPE over the whole head (half-split, as
``partial_rotary_factor`` 1.0 gives), causal and within ``sliding_window``,
then a pre-norm SwiGLU MLP, or for a mixture of experts the softmax router's
top-k experts with their gates renormalised to sum to 1 (every token to each
of its k experts: nothing is dropped), then a final norm and the untied
output head.  It imports nothing of the program: it draws its weights from
the seed with :mod:`portbench.weights`, layer by layer.

Float32 matrix products run with TF32 off.  ``precision="fp8"`` is the
control: every matrix product's operands (projections, the attention's
scores and values, experts, the head) are rounded to float8 e4m3 with one
scale per tensor (its largest magnitude maps to 448) before the float32
product; the router stays in float32, as the program keeps it.

Besides the model, the module states what the harness needs of an
architecture: the parameters' shapes and dtypes, the configuration-file
keys that must equal the program's (``CONFIG_KEYS``) and the program's
parts it does not compute (``lacks``).  Its counts of the work are
``portbench/counts.py``'s own formulas.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from ..weights import draw

__all__ = ["Reference", "param_shapes", "param_dtype", "padded_vocab", "CONFIG_KEYS",
           "lacks"]

FP8_MAX = 448.0
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ffn_width(mc) -> int:
    """The MLP's width, or each expert's where there are experts."""
    return mc.moe_d_ff if mc.n_experts else mc.d_ff


# each configuration-file key, and the program's ModelConfig field it must
# equal (or the function of the ModelConfig that gives the value)
CONFIG_KEYS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "use_qkv_bias": "qkv_bias", "sliding_window": "sliding_window",
    "num_local_experts": "n_experts", "num_experts_per_tok": "experts_per_token",
    "tie_word_embeddings": "tie_embeddings", "norm": "norm", "hidden_act": "act",
    "intermediate_size": _ffn_width,
}


def lacks(mc) -> List[str]:
    """The parts of the program's ModelConfig ``mc`` that this reference
    does not compute: any activation but SwiGLU's, softcaps, post-norms,
    a scaled embedding, a dense residual MLP, layers other than attention."""
    parts = {"act": mc.act != "silu", "final_softcap": bool(mc.final_softcap),
             "attn_softcap": bool(mc.attn_softcap), "post_norms": bool(mc.post_norms),
             "scale_embed": bool(mc.scale_embed), "dense_residual": bool(mc.dense_residual),
             "pattern": tuple(mc.pattern) != ("attn",)}
    return [name for name, present in parts.items() if present]


def padded_vocab(cfg: Dict) -> int:
    """Rows of the embedding and columns of the head, as the program lays
    them out: the vocabulary rounded up to 256 (the extra logits never win)."""
    return -(-cfg["vocab_size"] // 256) * 256


def _norm_params(prefix: str, d: int, norm: str) -> Dict[str, tuple]:
    names = {f"{prefix}.scale": (d,)}
    if norm == "layernorm":
        names[f"{prefix}.bias"] = (d,)
    return names


def layer_shapes(cfg: Dict, layer: int) -> Dict[str, tuple]:
    """{name: shape} of one layer's parameters."""
    D, Hq, Hkv, dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    F, E, norm = cfg["intermediate_size"], cfg["num_local_experts"], cfg["norm"]
    p = f"blocks.{layer}"
    shapes = _norm_params(f"{p}.norm1", D, norm)
    for w, (i, o) in {"wq": (D, Hq * dh), "wk": (D, Hkv * dh), "wv": (D, Hkv * dh),
                      "wo": (Hq * dh, D)}.items():
        shapes[f"{p}.attn.{w}.w"] = (i, o)
        if cfg["use_qkv_bias"] and w != "wo":
            shapes[f"{p}.attn.{w}.b"] = (o,)
    shapes.update(_norm_params(f"{p}.norm2", D, norm))
    if E:
        shapes.update({f"{p}.moe.router": (D, E), f"{p}.moe.wi": (E, D, F),
                       f"{p}.moe.wg": (E, D, F), f"{p}.moe.wo": (E, F, D)})
    else:
        shapes.update({f"{p}.mlp.wi": (D, F), f"{p}.mlp.wg": (D, F),
                       f"{p}.mlp.wo": (F, D)})
    return shapes


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """{name: shape} of every parameter, under the program's names."""
    D, V = cfg["hidden_size"], padded_vocab(cfg)
    shapes = {"embed": (V, D)}
    if not cfg["tie_word_embeddings"]:
        shapes["lm_head"] = (D, V)
    shapes.update(_norm_params("final_norm", D, cfg["norm"]))
    for layer in range(cfg["num_hidden_layers"]):
        shapes.update(layer_shapes(cfg, layer))
    return shapes


def param_dtype(cfg: Dict, name: str) -> torch.dtype:
    """The dtype a parameter is served in: the router in float32, the rest
    in the configuration's ``param_dtype``."""
    return torch.float32 if name.endswith(".router") else _DTYPES[cfg["param_dtype"]]


class Reference:
    """The reference model of ``cfg`` with the weights of ``seed``."""

    def __init__(self, cfg: Dict, seed: int, device, precision: str = "fp32",
                 margins: bool = False):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self._check()
        self.fp8 = precision == "fp8"
        # with ``margins``, each judged position's nearest routing tie over
        # the layers (a diagnostic for the readings; see :meth:`_moe`)
        self.margins: Optional[List[torch.Tensor]] = [] if margins else None

    def _check(self) -> None:
        """Refuses a configuration whose rotation :meth:`_rope` does not
        compute (a module that rotates part of each head overrides both)."""
        if self.cfg["partial_rotary_factor"] != 1.0:
            raise ValueError("the reference rotates whole heads only")

    # ------------------------------------------------------------ weights

    def _weights(self, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        return {n: draw(self.seed, n, s, param_dtype(self.cfg, n), self.device,
                        self.cfg["norm"]).float()
                for n, s in shapes.items()}

    # ------------------------------------------------------------ arithmetic

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        """x as float8 e4m3 would hold it, with one scale for the tensor."""
        if not self.fp8:
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._q(a), self._q(b))

    def _norm(self, w: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor):
        eps = self.cfg.get("layer_norm_eps", self.cfg.get("rms_norm_eps"))
        if self.cfg["norm"] == "layernorm":
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return (x - mu) / torch.sqrt(var + eps) * w[f"{prefix}.scale"] + w[f"{prefix}.bias"]
        rms = torch.sqrt((x * x).mean(-1, keepdim=True) + eps)
        return x / rms * (1.0 + w[f"{prefix}.scale"])

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, H, dh) at positions 0..S-1."""
        S, _, dh = x.shape
        inv = self.cfg["rope_theta"] ** (
            -torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
        ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
        sin, cos = torch.sin(ang).float()[:, None], torch.cos(ang).float()[:, None]
        x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, w, p: str, h: torch.Tensor, block: int = 1024) -> torch.Tensor:
        """One request's attention: h (S, D) -> (S, D)."""
        cfg = self.cfg
        Hq, Hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        S = h.shape[0]

        def proj(name, heads):
            y = self.mm(h, w[f"{p}.attn.{name}.w"])
            if f"{p}.attn.{name}.b" in w:
                y = y + w[f"{p}.attn.{name}.b"]
            return y.reshape(S, heads, dh)

        q, k, v = self._rope(proj("wq", Hq)), self._rope(proj("wk", Hkv)), proj("wv", Hkv)
        group = Hq // Hkv
        k = k.repeat_interleave(group, dim=1).transpose(0, 1)     # (Hq, S, dh)
        v = v.repeat_interleave(group, dim=1).transpose(0, 1)
        q = q.transpose(0, 1) * dh ** -0.5
        window = cfg.get("sliding_window")
        out = torch.empty_like(q)
        keys = torch.arange(S, device=h.device)
        for r0 in range(0, S, block):
            rows = torch.arange(r0, min(S, r0 + block), device=h.device)
            s = self.mm(q[:, rows], k.transpose(1, 2))             # (Hq, rows, S)
            valid = keys[None, :] <= rows[:, None]
            if window is not None:
                valid &= (rows[:, None] - keys[None, :]) < window
            s = torch.where(valid, s, -math.inf)
            out[:, rows] = self.mm(torch.softmax(s, dim=-1), v)
        return self.mm(out.transpose(0, 1).reshape(S, Hq * dh), w[f"{p}.attn.wo.w"])

    def _mlp(self, wi, wg, wo, x):
        return self.mm(torch.nn.functional.silu(self.mm(x, wg)) * self.mm(x, wi), wo)

    def _moe(self, w, p: str, x: torch.Tensor) -> torch.Tensor:
        """Every token to each of its top-k experts, gates renormalised."""
        k = self.cfg["num_experts_per_tok"]
        logits = torch.matmul(x, w[f"{p}.moe.router"])
        if self.margins is not None:
            # how near each token's routing is to a tie: its k-th router
            # logit less its (k+1)-th
            top = torch.topk(logits, k + 1, dim=-1).values
            self._margin = torch.minimum(self._margin, top[:, k - 1] - top[:, k])
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        y = torch.zeros_like(x)
        for e in range(probs.shape[-1]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                out = self._mlp(w[f"{p}.moe.wi"][e], w[f"{p}.moe.wg"][e],
                                w[f"{p}.moe.wo"][e], x[tok])
                y.index_add_(0, tok, out * gate[tok, slot][:, None])
        return y

    # ------------------------------------------------------------ forward

    @torch.no_grad()
    def logits(self, sequences: Sequence[torch.Tensor], positions: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """float32 logits (len(positions[i]), vocab) of each token sequence at
        the positions asked for, one layer's weights drawn at a time."""
        cfg = self.cfg
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            emb = self._weights({"embed": param_shapes(cfg)["embed"]})["embed"]
            xs = [emb[t.to(self.device).long()] for t in sequences]
            del emb
            margin = [torch.full((len(t),), math.inf, device=self.device) for t in sequences]
            for layer in range(cfg["num_hidden_layers"]):
                w = self._weights(layer_shapes(cfg, layer))
                p = f"blocks.{layer}"
                for i, x in enumerate(xs):
                    x = x + self._attention(w, p, self._norm(w, f"{p}.norm1", x))
                    h = self._norm(w, f"{p}.norm2", x)
                    if cfg["num_local_experts"]:
                        self._margin = margin[i]
                        x = x + self._moe(w, p, h)
                        margin[i] = self._margin
                    else:
                        x = x + self._mlp(w[f"{p}.mlp.wi"], w[f"{p}.mlp.wg"],
                                          w[f"{p}.mlp.wo"], h)
                    xs[i] = x
                del w
            names = {n: s for n, s in param_shapes(cfg).items()
                     if n == "lm_head" or n.startswith("final_norm")}
            if cfg["tie_word_embeddings"]:
                names["embed"] = param_shapes(cfg)["embed"]
            w = self._weights(names)
            head = w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]
            out = []
            if self.margins is not None:
                self.margins = [m[pos.to(self.device).long()] for m, pos in zip(margin, positions)]
            for x, pos in zip(xs, positions):
                h = self._norm(w, "final_norm", x[pos.to(self.device).long()])
                out.append(self.mm(h, head)[:, : cfg["vocab_size"]])
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
