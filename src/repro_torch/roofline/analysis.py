"""Roofline terms of a step (torch port of ``repro.roofline.analysis``).

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = sum over collective ops of wire_bytes_per_device / link_bw

The per-device FLOPs, bytes and collectives come from one run of the step
under ``roofline.op_cost.OpCounter``, which counts rank 0's local shards
(the counterpart of the reference's parse of the compiled SPMD HLO). Each
collective's wire bytes follow the ring algorithm, and a collective is
intra-pod (``ICI_BW``) or cross-pod (``DCN_BW``) by whether its group
spans more than one block of ``pod_size`` ranks.

Hardware model: one NVIDIA H100 SXM5 80GB a rank, eight to a node joined
by NVLink 4 (the figures of NVIDIA's H100 data sheet and Hopper
architecture whitepaper):
    989 TFLOP/s bf16 on the tensor cores, dense (no sparsity);
    67 TFLOP/s f32 outside the tensor cores;
    3.35 TB/s HBM3;
    450 GB/s a direction of NVLink 4 (900 GB/s both ways);
    50 GB/s a card between nodes: one 400 Gbit/s InfiniBand NDR port a
    card (an assumption, as the reference documents its own DCN rate).
``pod_size`` keeps the reference's meaning: the production meshes' pods
are 256 ranks, and a group that crosses a pod boundary goes at ``DCN_BW``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: bf16 tensor-core peak, dense (H100 SXM5 data sheet)
PEAK_FLOPS = 989e12
#: f32 outside the tensor cores (H100 SXM5 data sheet); the operation bound
#: of the f32 kernels
PEAK_FLOPS_F32 = 67e12
#: HBM3 bandwidth (H100 SXM5 data sheet)
HBM_BW = 3.35e12
#: NVLink 4, one direction (900 GB/s bidirectional, H100 SXM5 data sheet)
ICI_BW = 450e9
#: between nodes: one 400 Gbit/s InfiniBand NDR port a card (assumption)
DCN_BW = 50e9
#: one card's memory: ``torch.cuda.get_device_properties(0).total_memory``
#: of an NVIDIA H100 80GB HBM3 (700 W power limit), read on the card
DEVICE_MEMORY_BYTES = 85_017_493_504

def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm bytes a device sends for one collective over a group
    of ``n`` whose result takes ``result_bytes`` on each device."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes          # result = gathered size
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes              # result = scattered shard
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)                     # collective-permute


def crosses_pods(ranks: Iterable[int], pod_size: Optional[int]) -> bool:
    """Whether a group of ``ranks`` spans more than one block of
    ``pod_size`` ranks (never without a pod size)."""
    if not pod_size:
        return False
    return len({int(r) // pod_size for r in ranks}) > 1


@dataclass
class CollectiveOp:
    kind: str
    bytes_result: int
    group_size: int
    cross_pod: bool
    wire_bytes_per_device: float


@dataclass
class CollectiveSummary:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes_per_device for o in self.ops)

    def seconds(self) -> float:
        return sum(o.wire_bytes_per_device / (DCN_BW if o.cross_pod else ICI_BW)
                   for o in self.ops)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0.0) + o.wire_bytes_per_device
        return out


def summarize_collectives(records: Iterable[Tuple[str, int, int, bool]]
                          ) -> CollectiveSummary:
    """The counterpart of the reference's ``parse_collectives``: a
    ``CollectiveSummary`` from the collectives ``OpCounter`` recorded, each
    ``(kind, result bytes, group size, cross_pod)``, with the ring wire
    factors. Groups of one and empty results carry nothing, as there."""
    summary = CollectiveSummary()
    for kind, rbytes, n, cross in records:
        if n <= 1 or rbytes == 0:
            continue
        summary.ops.append(CollectiveOp(kind, int(rbytes), int(n), bool(cross),
                                        wire_bytes(kind, rbytes, n)))
    return summary


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_global: float
    hlo_total_flops_global: float
    n_devices: int
    coll_by_kind: Dict[str, float]
    n_collectives: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: useful-compute time / bound step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        useful = self.model_flops_global / self.n_devices / PEAK_FLOPS
        return useful / t

    @property
    def model_flops_ratio(self) -> float:
        if self.hlo_total_flops_global <= 0:
            return 0.0
        return self.model_flops_global / self.hlo_total_flops_global

    @property
    def hbm_fraction(self) -> float:
        """memory-term share of the bound step time (the roofline target for
        decode steps, which are HBM-bound by construction)."""
        t = self.step_time_s
        return self.memory_s / t if t > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "compute_fraction": self.compute_fraction,
            "hbm_fraction": self.hbm_fraction,
            "model_flops_ratio": self.model_flops_ratio,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "coll_by_kind": self.coll_by_kind,
            "n_collectives": self.n_collectives,
        }


def analyze(cost, n_devices: int, model_flops_global: float) -> Roofline:
    """The roofline of one counted step: ``cost`` is an ``OpCounter`` (or
    anything with ``flops``, ``bytes`` and ``collectives``) that ran it on
    rank 0. ``hlo_total_flops_global`` keeps the reference's name: the
    counted FLOPs times the device count."""
    coll = summarize_collectives(cost.collectives)
    ici: Dict[str, float] = {}
    dcn: Dict[str, float] = {}
    for o in coll.ops:
        d = dcn if o.cross_pod else ici
        d[o.kind] = d.get(o.kind, 0.0) + o.wire_bytes_per_device
    flops, nbytes = float(cost.flops), float(cost.bytes)
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=nbytes / HBM_BW,
        collective_s=coll.seconds(),
        flops_per_device=flops,
        bytes_per_device=nbytes,
        wire_bytes_per_device=coll.total_wire_bytes,
        model_flops_global=model_flops_global,
        hlo_total_flops_global=flops * n_devices,
        n_devices=n_devices,
        coll_by_kind={**{f"ici/{k}": v for k, v in ici.items()},
                      **{f"dcn/{k}": v for k, v in dcn.items()}},
        n_collectives=len(coll.ops),
    )


def model_flops(cfg, shape_cfg) -> float:
    """MODEL_FLOPS per the assignment: 6·N·D train (N_active for MoE);
    2·N_active·B per decoded token; 2·N_active·B·S prefill."""
    n_active = cfg.n_active_params()
    if shape_cfg.kind == "train":
        return 6.0 * n_active * shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "prefill":
        return 2.0 * n_active * shape_cfg.global_batch * shape_cfg.seq_len
    return 2.0 * n_active * shape_cfg.global_batch   # decode: one token
