"""Cluster model: heterogeneous accelerator pools, nodes, pricing (paper Table 1).

Counterpart of ``repro/core/cluster.py``, copied so that the port imports
nothing of the JAX package.  The planner prices the paper's cluster (H20
rollout nodes, H800 training nodes), not the card the port runs on.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass


@dataclass(frozen=True)
class AcceleratorType:
    name: str
    tflops: float           # bf16 compute
    hbm_gb: float
    hbm_tbps: float
    price_per_gpu_hour: float


# Paper Table 1 (H20 rollout pool / H800 training pool).
H20 = AcceleratorType("H20", 148.0, 96.0, 4.0, 1.85)
H800 = AcceleratorType("H800", 989.5, 80.0, 3.35, 5.28)
# the JAX package's TPU stand-in, with its roofline constants
V5E = AcceleratorType("v5e", 197.0, 16.0, 0.819, 1.2)

GPUS_PER_NODE = 8
HOST_MEM_GB = 1536.0      # 1-2 TB high-memory nodes (paper C3)


@dataclass
class Node:
    node_id: str
    accel: AcceleratorType
    gpus: int = GPUS_PER_NODE
    host_mem_gb: float = HOST_MEM_GB

    @property
    def price_per_hour(self) -> float:
        return self.gpus * self.accel.price_per_gpu_hour


class NodeAllocator:
    """Hands out nodes from the two physical pools (328 + 328 GPUs default)."""

    def __init__(self, n_rollout_gpus: int = 328, n_train_gpus: int = 328,
                 rollout_accel: AcceleratorType = H20,
                 train_accel: AcceleratorType = H800,
                 elastic: bool = True):
        self.rollout_accel, self.train_accel = rollout_accel, train_accel
        self._ids = itertools.count()
        self.free_rollout = [Node(f"R{i}", rollout_accel)
                             for i in range(n_rollout_gpus // GPUS_PER_NODE)]
        self.free_train = [Node(f"T{i}", train_accel)
                           for i in range(n_train_gpus // GPUS_PER_NODE)]
        self.elastic = elastic          # allow exceeding physical pool (cloud)
        self.peak_rollout = 0
        self.peak_train = 0
        self._out_rollout: set[str] = set()
        self._out_train: set[str] = set()

    def _take(self, pool: list[Node], n: int, kind: str) -> list[Node]:
        if len(pool) < n:
            if not self.elastic:
                raise RuntimeError(f"{kind} pool exhausted")
            accel = self.rollout_accel if kind == "rollout" else self.train_accel
            for _ in range(n - len(pool)):
                pool.append(Node(f"{kind[0].upper()}x{next(self._ids)}", accel))
        out = [pool.pop() for _ in range(n)]
        return out

    def alloc_rollout(self, n_nodes: int) -> list[Node]:
        nodes = self._take(self.free_rollout, n_nodes, "rollout")
        self._out_rollout |= {n.node_id for n in nodes}
        self.peak_rollout = max(self.peak_rollout, len(self._out_rollout))
        return nodes

    def alloc_train(self, n_nodes: int) -> list[Node]:
        nodes = self._take(self.free_train, n_nodes, "train")
        self._out_train |= {n.node_id for n in nodes}
        self.peak_train = max(self.peak_train, len(self._out_train))
        return nodes

    def release(self, nodes: list[Node]) -> None:
        for n in nodes:
            if n.accel is self.train_accel and n.node_id in self._out_train:
                self._out_train.discard(n.node_id)
                self.free_train.append(n)
            elif n.node_id in self._out_rollout:
                self._out_rollout.discard(n.node_id)
                self.free_rollout.append(n)
