"""Roofline terms of a step on the H100, from the cost walk's counts.

Counterpart of ``repro/launch/roofline.py``.  The hardware constants are
the H100 SXM5's, from NVIDIA's H100 Tensor Core GPU datasheet:

  dense bf16 989 TFLOP/s, tf32 495 TFLOP/s, fp32 67 TFLOP/s (no sparsity),
  HBM3 3.35 TB/s;
  NVLink 4: 900 GB/s a GPU, both directions together.

The collective rates are ``sync.topology.ClusterTopology``'s links (the
model the weight sync already uses): an axis inside one 8-GPU NVLink node
moves at its ``nvlink_gbps`` (3200 Gbps, 400 GB/s each way, below the
datasheet's 450 GB/s each way), an axis across nodes at its
``intra_cluster_gbps`` (400 Gbps, one ConnectX-7 NIC a GPU, 50 GB/s).

The walk (``launch/cost.py``) counts one rank's FLOPs and bytes after
placement, so the compute and memory terms are per chip; the collective
term is the rank's collective bytes over the link of the slowest axis its
mesh spans.  These are modelled terms for an H100, not times taken on one.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.sync.topology import ClusterTopology

PEAK = {"bfloat16": 989e12, "tfloat32": 495e12,  # dense ops/s by input type
        "float32": 67e12}
PEAK_FLOPS = PEAK["bfloat16"]
HBM_BPS = 3.35e12          # device memory rate, bytes/s
NODE_GPUS = 8              # GPUs an NVLink node joins
NVLINK_BPS = ClusterTopology().nvlink_gbps * 1e9 / 8
CROSS_NODE_BPS = ClusterTopology().intra_cluster_gbps * 1e9 / 8


def collective_bps(n_chips: int) -> float:
    """The link rate of a mesh of ``n_chips``: NVLink when it fits in one
    node, else the cross-node rate (every axis of the 256- and 512-rank
    production meshes spans more than one 8-GPU node)."""
    return NVLINK_BPS if n_chips <= NODE_GPUS else CROSS_NODE_BPS


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float             # per chip: the walk's FLOPs
    hlo_bytes: float             # per chip: the walk's bytes
    collective_bytes_per_chip: float
    collective_ops: int
    model_flops: float           # global useful FLOPs (6ND / 2ND)
    model_flops_per_chip: float
    useful_flop_ratio: float     # model / hlo (per chip)
    bottleneck: str
    step_time_s: float           # max of the three terms
    mfu: float                   # model_flops_per_chip / (step_time * peak)

    def to_dict(self):
        return asdict(self)


def analyze(costs, *, n_chips: int, model_flops: float) -> RooflineTerms:
    """Roofline terms of one rank's walked :class:`~repro_torch.launch.
    cost.Costs` on a mesh of ``n_chips`` H100s."""
    flops, byts = costs.flops, costs.bytes
    coll_bytes = costs.collective_bytes
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BPS
    collective_s = coll_bytes / collective_bps(n_chips)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(compute_s, memory_s, collective_s)
    mf_chip = model_flops / n_chips
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops=flops, hlo_bytes=byts,
        collective_bytes_per_chip=coll_bytes,
        collective_ops=int(costs.coll_ops),
        model_flops=model_flops, model_flops_per_chip=mf_chip,
        useful_flop_ratio=mf_chip / flops if flops else 0.0,
        bottleneck=bottleneck, step_time_s=step,
        mfu=mf_chip / (step * PEAK_FLOPS) if step else 0.0)


def model_flops_for(cfg, shape) -> float:
    """Useful-FLOP estimate: 6·N_active·D for training, 2·N_active·D for
    inference forward (D = tokens processed this step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def memory_report(costs, *, argument_bytes: int, output_bytes: int,
                  alias_bytes: int) -> dict:
    """The reference's ``memory_analysis`` fields for one rank of an eager
    step: its arguments' local bytes, its outputs' (``alias`` the part that
    is the arguments' own storage, updated in place), the walk's peak of
    live intermediates as the temporaries; eager PyTorch generates no
    code.  ``resident_bytes = args + temp + max(out - alias, 0)``."""
    temp = int(costs.peak_bytes)
    return {"argument_size_in_bytes": argument_bytes,
            "output_size_in_bytes": output_bytes,
            "temp_size_in_bytes": temp,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": alias_bytes,
            "resident_bytes": argument_bytes + temp
            + max(output_bytes - alias_bytes, 0)}
