"""Roofline terms on one NVIDIA H100 (the JAX package's
``launch/roofline.py``, which models a TPU v5e).

Per (arch x shape x mesh):

    compute    = FLOPs_per_device / peak_flops_per_card
    memory     = bytes_per_device / hbm_bw_per_card
    collective = moved_bytes_per_device / ici_bw (one NVLink 4 direction)

FLOPs and bytes come from ``Lowered.cost_analysis()`` of a step run on the
``meta`` device (``repro_torch.launch.steps.lower_step``).  Collective
bytes are parsed from ``Lowered.as_text()``: one line per recorded op in
XLA's ``dtype[d0,d1]`` notation, the port's collectives under XLA's op
names, so the JAX package's regexes and ring movement factors apply
unchanged (all-reduce moves ~2x its payload, gather/scatter ~1x,
all-to-all/permute ~1x of the local shard).

Hardware constants: the H100 SXM data sheet.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989e12          # dense bf16 tensor cores, H100 SXM data sheet
PEAK_FLOPS_F32 = 67e12       # float32 outside the tensor cores, same sheet
HBM_BW = 3.35e12             # bytes/s of HBM3, same sheet
ICI_BW = 450e9               # NVLink 4, bytes/s a direction, same sheet

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# result-shape patterns like: bf16[16,512] or (f32[8], f32[8])
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", re.M)

_MOVE_FACTOR = {
    "all-reduce": 2.0,        # ring reduce-scatter + all-gather
    "all-gather": 1.0,        # output bytes ~ moved bytes
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = PEAK_FLOPS_F32) -> Tuple[float, str]:
    """(the least ms the card could take, what bounds it): the larger of
    ``n_bytes`` over the HBM rate and ``n_ops`` over ``ops_per_s``."""
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _shape_bytes(sig: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(sig):
        dt, dims = m.groups()
        if dt not in _DTYPE_BYTES:
            continue
        total += math.prod(int(d) for d in dims.split(",") if d) \
            * _DTYPE_BYTES[dt]
    return total


def parse_collectives(text: str) -> Dict[str, Dict[str, float]]:
    """Per-op-kind {count, bytes, moved} from a recorded step's text.

    ``bytes`` = result payload of each collective (per device); ``moved`` =
    payload x ring movement factor.  ``-done`` ops are skipped so async
    pairs are not counted twice."""
    out: Dict[str, Dict[str, float]] = {}
    for m in _COLLECTIVE_RE.finditer(text):
        sig, kind = m.groups()
        if "-done(" in m.group(0):
            continue
        b = _shape_bytes(sig)
        rec = out.setdefault(kind, {"count": 0, "bytes": 0.0, "moved": 0.0})
        rec["count"] += 1
        rec["bytes"] += b
        rec["moved"] += b * _MOVE_FACTOR[kind]
    return out


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, Dict[str, float]]
    peak_memory_bytes: Optional[float] = None
    model_flops: Optional[float] = None          # 6*N*D (global)
    model_bytes: Optional[float] = None          # HBM floor (global), decode
    kind: str = "train"                          # train | prefill | decode

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_s(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs: catches remat/redundancy waste."""
        if not self.model_flops:
            return None
        return self.model_flops / (self.flops_per_device * self.chips)

    @property
    def useful_bytes_ratio(self) -> Optional[float]:
        """model_bytes / counted bytes: how much HBM traffic is
        irreducible (params + state read once per step)."""
        if not self.model_bytes:
            return None
        return self.model_bytes / (self.bytes_per_device * self.chips)

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Useful-work time / achievable step time (the score).

        Train/prefill are compute-normalised (useful = MODEL_FLOPS at
        peak).  Decode is memory-normalised: one token must stream params
        + decode state through HBM once, so useful = model_bytes at full
        bandwidth."""
        if self.kind == "decode":
            if not self.model_bytes:
                return None
            t_useful = self.model_bytes / (self.chips * HBM_BW)
            return t_useful / self.roofline_s
        if not self.model_flops:
            return None
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / self.roofline_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 roofline_s=self.roofline_s,
                 useful_flops_ratio=self.useful_flops_ratio,
                 useful_bytes_ratio=self.useful_bytes_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_bytes_for(cfg, shape, n_params: int, model=None) -> float:
    """Irreducible HBM bytes per decode step (global): every parameter and
    every decode-state byte (``decode_state_shapes``) is read exactly once
    to emit one token a sequence."""
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    total = n_params * dtype_bytes
    if model is not None and shape.kind == "decode":
        structs, _ = model.decode_state_shapes(shape, False)
        total += sum(t.numel() * t.element_size() for t in structs.leaves())
    return float(total)


def model_flops_for(cfg, shape, n_params: int, n_active: Optional[int] = None
                    ) -> float:
    """6*N*D for training; 2*N*D_new for serving steps (decode: D_new =
    global_batch tokens; prefill: the full prompt)."""
    n = n_active if (n_active and cfg.family == "moe") else n_params
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def kernel_mode_for_target(platform: str) -> str:
    """The kernel mode a roofline cell on ``platform`` is costed under:
    ``"cuda_kernel"`` (the hand-written kernels) on ``"cuda"``, and
    ``"torch"`` (the plain versions) on ``"cpu"`` and ``"meta"``.  Off the
    card the cell runs the plain data plane, which routes packets by the
    same flat address as the kernels, so the count sees address-routed
    dispatch.  Pass the result to ``build_step(kernel_mode=...)``."""
    if platform == "cuda":
        return "cuda_kernel"
    if platform in ("cpu", "meta"):
        return "torch"
    raise ValueError(f"unknown platform {platform!r} (cuda, cpu or meta)")


def dense_routing_bytes(text: str, tokens: int, ports_x_capacity: int,
                        min_dtype_bytes: int = 2) -> int:
    """Bytes of the largest [T, P*C]-sized intermediate found in ``text``.

    The fabric's claim is that forward *and backward* route by flat
    address: no dense [tokens, n_ports*capacity] selection tensor is ever
    materialised (the Mesh-TF one-hot formulation the scatter path exists
    to avoid).  Returns the byte size of the worst offender, 0 if none.

    A shape counts iff it has a ``tokens`` dim and its remaining dims
    multiply to exactly ``ports_x_capacity``: that matches every layout of
    the selection tensor ([T,P*C], [T,P,C], [P,C,T], ...) while ordinary
    activations ([T, d_model], [T, d_ff]) only collide if the probe
    geometry makes a feature dim equal P*C (pick geometries that don't).
    """
    worst = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.groups()
        if dt not in _DTYPE_BYTES or _DTYPE_BYTES[dt] < min_dtype_bytes:
            continue
        sizes = [int(d) for d in dims.split(",") if d]
        if tokens not in sizes:
            continue
        n = math.prod(sizes)
        if n == tokens * ports_x_capacity:
            worst = max(worst, n * _DTYPE_BYTES[dt])
    return worst


def extract(lowered) -> Tuple[float, float, Dict, Optional[float]]:
    """(flops, bytes, collectives, peak memory) of a ``Lowered`` step."""
    ca = lowered.cost_analysis()
    colls = parse_collectives(lowered.as_text())
    mem = lowered.memory_analysis()
    peak = float(mem.temp_size_in_bytes + mem.argument_size_in_bytes
                 + mem.output_size_in_bytes - mem.alias_size_in_bytes)
    return (float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0)),
            colls, peak)
