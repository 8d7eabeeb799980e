"""Feed-forward blocks: SwiGLU / GeGLU / GELU."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ParamDef, gelu_f32, silu_f32


def mlp_defs(d_model: int, d_ff: int, act: str) -> Dict[str, ParamDef]:
    """Gated variants fuse gate+up into one projection for a single GEMM."""
    f_in = 2 * d_ff if act in ("swiglu", "geglu") else d_ff
    return {"w_in": ParamDef((d_model, f_in), ("fsdp", "tp")),
            "w_out": ParamDef((d_ff, d_model), ("tp", "fsdp"))}


def gated_act(h: torch.Tensor, act: str, dtype) -> torch.Tensor:
    """The activation between the two projections, in float32."""
    if act in ("swiglu", "geglu"):
        gate, up = h.chunk(2, dim=-1)
        a = silu_f32(gate) if act == "swiglu" else gelu_f32(gate)
        return (a * up.float()).to(dtype)
    return gelu_f32(h).to(dtype)


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = gated_act(x @ params["w_in"], act, x.dtype)
    return h @ params["w_out"]
