"""Topology-aware model synchronization (paper §5.2) as ``torch.distributed``
collectives.  Counterpart of ``repro/sync/model_sync.py``.

The disaggregated layout is a 2-D mesh ("cluster", "intra"): row 0 is the
training pool (it holds the fresh weights), row 1 the rollout pool.
RollMux's hierarchical two-stage transfer:

* stage 1 (inter-cluster scatter): rank (0, i) sends shard i of the model
  to rank (1, i), so exactly one model copy crosses the slow link, as
  ``|intra|`` parallel point-to-point streams;
* stage 2 (intra-cluster broadcast): an all-gather over "intra" on each
  row, on the fast local fabric.

The veRL baseline, a flat all-gather spanning both pools, is kept for the
collective-bytes comparison: it moves ``2 |intra|`` times the hierarchical
sync's bytes across the cluster boundary.

Each rank passes the flat model as it holds it (the rollout row anything,
such as stale weights) and gets the padded full model back, as each device
of the reference's ``(2, n, M)`` output holds it.  Every collective goes
through one small seam: :class:`MeshComm` issues it over the mesh's
process groups, and its base :class:`RecordingComm` only logs each one's
bytes.  :func:`sync_collective_bytes` runs the very sync functions once a
rank on ``meta`` tensors through the recording seam, the counterpart of
the reference's ``lower_sync`` and its HLO walk, so that counting a 65.5
GB model costs nothing; ``lower_sync`` itself, which lowers a sync to
HLO, has no port.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.train.checkpoints import _rebuild
from repro_torch.train.optimizer import tree_leaves

MODES = ("hierarchical", "flat")


def make_sync_mesh(n_per_cluster: int, device_type: str):
    """The (2, n) ("cluster", "intra") mesh over a world of 2n ranks: rank
    ``c·n + i`` sits at row c (0 = training pool, 1 = rollout pool)."""
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != 2 * n_per_cluster:
        raise RuntimeError(
            f"a sync mesh of 2 x {n_per_cluster} needs a world of "
            f"{2 * n_per_cluster} ranks; "
            + (f"this one has {world}" if world else "none is initialized"))
    return init_device_mesh(device_type, (2, n_per_cluster),
                            mesh_dim_names=("cluster", "intra"))


class RecordingComm:
    """The collectives of a sync for the rank at ``coord = (row, i)`` of a
    (2, n) mesh, moving nothing: each call logs ``(kind, crosses the
    cluster boundary, bytes)`` once for every peer whose data it moves.  A
    point-to-point transfer is logged at its sender; an all-gather logs,
    at each rank, the shards it receives from the other members."""

    def __init__(self, coord: tuple[int, int], n: int):
        self.coord, self.n = tuple(coord), n
        self.log: list[tuple[str, bool, int]] = []

    def _record(self, kind: str, peers, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        self.log += [(kind, p[0] != self.coord[0], nbytes)
                     for p in peers if p != self.coord]

    def members(self, axis: str) -> list[tuple[int, int]]:
        """The coordinates of an all-gather's group in gather order:
        ``"intra"`` this rank's row, ``"world"`` both rows."""
        rows = [self.coord[0]] if axis == "intra" else [0, 1]
        return [(c, j) for c in rows for j in range(self.n)]

    def send(self, t: torch.Tensor, to: tuple[int, int]) -> None:
        self._record("p2p", [to], t)

    def recv(self, t: torch.Tensor, frm: tuple[int, int]) -> None:
        pass

    def all_gather(self, out: torch.Tensor, t: torch.Tensor,
                   axis: str) -> None:
        """``out`` = the members' ``t``, concatenated in gather order."""
        self._record("all_gather", self.members(axis), t)

    def bytes(self) -> dict:
        """``{kind: {"cross_cluster": B, "intra_cluster": B}}`` of the
        log."""
        out: dict = {}
        for kind, cross, nbytes in self.log:
            d = out.setdefault(kind, {"cross_cluster": 0, "intra_cluster": 0})
            d["cross_cluster" if cross else "intra_cluster"] += nbytes
        return out


class MeshComm(RecordingComm):
    """The collectives over a ("cluster", "intra") ``DeviceMesh``, logged
    as :class:`RecordingComm` logs them."""

    def __init__(self, mesh):
        if mesh.mesh_dim_names != ("cluster", "intra"):
            raise ValueError(f"a sync mesh has dims ('cluster', 'intra'), "
                             f"not {mesh.mesh_dim_names}")
        super().__init__(mesh.get_coordinate(), mesh.size(1))
        self.mesh = mesh

    def _rank(self, coord) -> int:
        return int(self.mesh.mesh[coord])

    def send(self, t, to):
        super().send(t, to)
        dist.send(t, self._rank(to))

    def recv(self, t, frm):
        dist.recv(t, self._rank(frm))

    def all_gather(self, out, t, axis):
        super().all_gather(out, t, axis)
        if axis == "intra":
            group = self.mesh.get_group("intra")
        elif self.mesh.mesh.flatten().tolist() == list(
                range(dist.get_world_size())):
            group = dist.group.WORLD
        else:
            raise ValueError("the flat baseline needs a mesh of the whole "
                             "world in rank order (make_sync_mesh)")
        dist.all_gather(list(out.view(-1, t.numel()).unbind(0)), t,
                        group=group)


def _comm(mesh) -> RecordingComm:
    return mesh if isinstance(mesh, RecordingComm) else MeshComm(mesh)


def _padded_shard(comm: RecordingComm, flat: torch.Tensor):
    """The flat model padded with zeros to a multiple of n, and this
    rank's shard of it, ``i`` of n."""
    flat = flat.reshape(-1)
    pad = (-flat.numel()) % comm.n
    x = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    m = x.numel() // comm.n
    i = comm.coord[1]
    return x, x[i * m:(i + 1) * m]


def hierarchical_sync(mesh, flat: torch.Tensor) -> torch.Tensor:
    """Stage 1 sends the training row's shard i to rank (1, i); stage 2
    all-gathers the shards over "intra" on each row.  ``mesh`` is a sync
    mesh or a :class:`RecordingComm`; returns the padded full model, the
    training row's, on every rank."""
    comm = _comm(mesh)
    x, shard = _padded_shard(comm, flat)
    row, i = comm.coord
    if row == 0:
        comm.send(shard, (1, i))
        mine = shard
    else:
        mine = torch.empty_like(shard)
        comm.recv(mine, (0, i))
    out = x.new_empty(x.numel())
    comm.all_gather(out, mine, "intra")
    return out


def flat_sync_baseline(mesh, flat: torch.Tensor) -> torch.Tensor:
    """veRL-style flat all-gather spanning BOTH pools: every rank pulls
    every shard of both rows; one model's length (the training row's
    shards) is kept."""
    comm = _comm(mesh)
    x, shard = _padded_shard(comm, flat)
    full = x.new_empty(2 * x.numel())
    comm.all_gather(full, shard, "world")
    return full[:x.numel()]


def sync_collective_bytes(n_per_cluster: int, model_bytes: int, *,
                          mode: str) -> dict:
    """The bytes each collective kind of a sync of a bf16 model of
    ``model_bytes`` moves across the cluster boundary and inside a row,
    summed over the 2n ranks: ``{kind: {"cross_cluster": B,
    "intra_cluster": B}}``.  Runs the sync function of ``mode`` once a
    rank on a ``meta`` tensor through :class:`RecordingComm`."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: choose from {MODES}")
    fn = hierarchical_sync if mode == "hierarchical" else flat_sync_baseline
    flat = torch.empty(model_bytes // 2, dtype=torch.bfloat16, device="meta")
    total: dict = {}
    for rank in range(2 * n_per_cluster):
        comm = RecordingComm(divmod(rank, n_per_cluster), n_per_cluster)
        fn(comm, flat)
        for kind, d in comm.bytes().items():
            t = total.setdefault(kind, dict.fromkeys(d, 0))
            for k, v in d.items():
                t[k] += v
    return total


def sync_params_between_jobs(train_params, rollout_params):
    """Single-host execution plane: the 'sync' phase of the RL loop — the
    updated training tensors themselves (no copy) in the rollout actor's
    tree structure."""
    if not _same_structure(train_params, rollout_params):
        raise ValueError("the training and rollout trees differ in "
                         "structure")
    return _rebuild(rollout_params, tree_leaves(train_params))


def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(b) is type(a) and len(a) == len(b)
                and all(map(_same_structure, a, b)))
    return not isinstance(b, (dict, list, tuple))


def flatten_params(params) -> torch.Tensor:
    """The leaves in tree order (dict keys sorted, as the reference's
    ``jax.tree.leaves``), flattened and concatenated in their promoted
    dtype."""
    leaves = tree_leaves(params)
    dt = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
    return torch.cat([t.reshape(-1).to(dt) for t in leaves])


def unflatten_params(flat: torch.Tensor, like):
    """:func:`flatten_params`'s inverse: a new tree of ``like``'s
    structure, each leaf a copy of its stretch of ``flat`` in the leaf's
    shape, dtype and device.  ``flat`` may be longer (a sync's padding)."""
    leaves = tree_leaves(like)
    sizes = [t.numel() for t in leaves]
    if flat.numel() < sum(sizes):
        raise ValueError(f"a flat model of {flat.numel()} elements is "
                         f"shorter than the tree's {sum(sizes)}")
    pieces = flat.reshape(-1)[:sum(sizes)].split(sizes)
    return _rebuild(like, [torch.empty_like(t).copy_(p.view(t.shape))
                           for t, p in zip(leaves, pieces)])
