"""Feed-forward blocks: SwiGLU / GeGLU / plain GELU."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import gather_dim
from repro_torch.models.common import act_fn, dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.compute_dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        params = {
            "w_gate": dense_init(gen, d, (d, f), dt),
            "w_up": dense_init(gen, d, (d, f), dt),
            "w_down": dense_init(gen, f, (f, d), dt),
        }
        axes = {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
                "w_down": ("tp", "fsdp")}
    else:
        params = {
            "w_up": dense_init(gen, d, (d, f), dt),
            "w_down": dense_init(gen, f, (f, d), dt),
        }
        axes = {"w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}
    return params, axes


def mlp_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = gather_dim(x, 1)
    if cfg.mlp_act == "swiglu":
        act = F.silu(x @ params["w_gate"])
        return (act * (x @ params["w_up"])) @ params["w_down"]
    if cfg.mlp_act == "geglu":
        act = F.gelu(x @ params["w_gate"], approximate="tanh")
        return (act * (x @ params["w_up"])) @ params["w_down"]
    h = act_fn("gelu")(x @ params["w_up"])
    return h @ params["w_down"]
