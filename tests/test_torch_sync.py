"""The port's weight sync (``repro_torch.sync``) against the JAX package's.

* ``ClusterTopology`` gives the reference's value for every method on a
  grid of model bytes and GPU counts.
* ``hierarchical_sync`` and ``flat_sync_baseline`` run on gloo worlds of
  2 x 1, 2 x 2 and 2 x 3 ranks on the CPU (a 1001-element bf16 model, so
  that n 2 and 3 pad), with the rollout row fed stale weights: each rank's
  output equals, bit for bit, the reference's output on that device, from
  one JAX subprocess with six forced host devices.
* ``sync_collective_bytes``: the hierarchical sync moves one padded model
  copy across the cluster boundary, the flat baseline 2n of them, the
  ratio of the reference's HLO walk (``analyze_hlo``: the flat all-gather's
  bytes over the hierarchical collective-permute's); its count equals what
  the seam logged in the gloo run.
* ``sync_params_between_jobs`` aliases; ``flatten_params`` and
  ``unflatten_params`` round-trip a reduced model of every family bit for
  bit, and a bfloat16 zamba2 whose ``A_log``, ``D`` and ``dt_bias`` stay
  float32.
* ``make_sync_mesh`` raises on a world that is not 2n ranks.

Each world's ranks are spawned processes that meet over a file store under
``tmp_path`` (no port).
"""
import dataclasses
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import list_archs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NS = (1, 2, 3)
LENGTH = 1001                 # elements of the bf16 model (pads at n 2, 3)


def _bf16_bits(seed: int) -> np.ndarray:
    """LENGTH seeded normal values rounded to bf16, as int16 bit patterns."""
    x = np.random.RandomState(seed).standard_normal(LENGTH).astype(
        np.float32)
    return (x.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)


FRESH, STALE = _bf16_bits(0), _bf16_bits(1)

REFERENCE = r"""
import json, sys
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.hlo_cost import analyze_hlo
from repro.sync import (flat_sync_baseline, hierarchical_sync, lower_sync,
                        make_sync_mesh)
bits = np.load(sys.argv[1])
x = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
outs, coll = {}, {}
for n in (1, 2, 3):
    mesh = make_sync_mesh(n)
    for mode, fn in (("hierarchical", hierarchical_sync),
                     ("flat", flat_sync_baseline)):
        y = jax.jit(partial(fn, mesh))(x)
        outs[f"{mode}{n}"] = np.asarray(
            jax.lax.bitcast_convert_type(y, jnp.int16))
        txt = lower_sync(n, 2000 * n, mode=mode).compile().as_text()
        coll[f"{mode}{n}"] = dict(analyze_hlo(txt).coll)
np.savez(sys.argv[2], **outs)
print(json.dumps(coll))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's sync outputs ``{mode n: (2, n, M) int16}`` on
    FRESH and its HLO collective bytes, from one subprocess with six host
    devices."""
    d = tmp_path_factory.mktemp("sync_ref")
    np.save(d / "bits.npy", FRESH)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "bits.npy"),
                          str(d / "outs.npz")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    coll = json.loads(res.stdout.strip().splitlines()[-1])
    return dict(np.load(d / "outs.npz")), coll


def _sync_rank(rank, world, store, out_dir):
    """One rank of a 2 x n gloo world: both syncs through a logging
    ``MeshComm``, the training row on FRESH, the rollout row on STALE."""
    import torch.distributed as dist

    from repro_torch.sync import make_sync_mesh
    from repro_torch.sync.model_sync import (MeshComm, flat_sync_baseline,
                                             hierarchical_sync)

    torch.set_num_threads(1)
    n = world // 2
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        mesh = make_sync_mesh(n, "cpu")
        bits = FRESH if rank < n else STALE
        flat = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        res = {"coord": tuple(mesh.get_coordinate())}
        for mode, fn in (("hierarchical", hierarchical_sync),
                         ("flat", flat_sync_baseline)):
            comm = MeshComm(mesh)
            out = fn(comm, flat)
            res[mode] = out.view(torch.int16).numpy().copy()
            res[f"{mode}_bytes"] = comm.bytes()
        wrong = []
        for m in (n - 1, n + 1):
            try:
                make_sync_mesh(m, "cpu")
            except RuntimeError:
                wrong.append(m)
        res["refused"] = wrong
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """``{n: [each rank's results]}`` of the worlds of 2n ranks."""
    import torch.multiprocessing as mp

    runs = {}
    for n in NS:
        d = tmp_path_factory.mktemp(f"sync_gloo{n}")
        mp.start_processes(_sync_rank, args=(2 * n, str(d / "store"),
                                             str(d)),
                           nprocs=2 * n, start_method="spawn")
        runs[n] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                   for r in range(2 * n)]
    return runs


def test_topology_matches_reference():
    from repro.sync import ClusterTopology as Ref

    from repro_torch.sync import ClusterTopology
    assert dataclasses.asdict(ClusterTopology()) == dataclasses.asdict(Ref())
    port, ref = ClusterTopology(), Ref()
    for b in (1e6, 3.7e9, 14e9, 15.4e9, 28e9, 65.5e9, 275e9):
        for n in (1, 2, 7, 8, 16, 32):
            for name, args in (("flat_fetch_time_s", (b, n)),
                               ("ring_allgather_time_s", (b, 2 * n)),
                               ("hierarchical_time_s", (b, n, n + 1)),
                               ("speedup_single_node", (b, n)),
                               ("speedup_multi_node", (b, n))):
                assert getattr(port, name)(*args) == getattr(ref, name)(
                    *args), (name, args)
        assert port.cold_start_s(b) == ref.cold_start_s(b)
        assert port.cold_start_s(b, control_plane_s=3.0) == \
            ref.cold_start_s(b, control_plane_s=3.0)
        assert port.warm_start_s(b) == ref.warm_start_s(b)
        assert port.warm_start_s(b, 64.0, 0.1) == ref.warm_start_s(
            b, 64.0, 0.1)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", ("hierarchical", "flat"))
def test_sync_bit_for_bit_with_reference(reference, gloo_runs, mode, n):
    outs, _ = reference
    ref = outs[f"{mode}{n}"]
    padded = -(-LENGTH // n) * n
    assert ref.shape == (2, n, padded)
    for r, res in enumerate(gloo_runs[n]):
        c, i = res["coord"]
        assert (c, i) == divmod(r, n)
        np.testing.assert_array_equal(res[mode], ref[c, i])
        np.testing.assert_array_equal(res[mode][:LENGTH], FRESH)
        assert not res[mode][LENGTH:].any()         # the zero padding
    # the rollout row's stale input reached no output
    assert not np.array_equal(FRESH, STALE)


@pytest.mark.parametrize("n", NS)
def test_collective_bytes(reference, gloo_runs, n):
    from repro_torch.sync import sync_collective_bytes

    _, coll = reference
    padded_bytes = 2 * -(-LENGTH // n) * n
    hier = sync_collective_bytes(n, 2 * LENGTH, mode="hierarchical")
    flat = sync_collective_bytes(n, 2 * LENGTH, mode="flat")
    # one padded model copy crosses the boundary, all of it point to point
    assert hier["p2p"] == {"cross_cluster": padded_bytes, "intra_cluster": 0}
    assert hier.get("all_gather", {}).get("cross_cluster", 0) == 0
    assert flat["all_gather"]["cross_cluster"] == 2 * n * padded_bytes
    # the reference's HLO walk gives the same ratio (at its own sizes)
    for m in NS:
        h = sync_collective_bytes(m, 2000 * m, mode="hierarchical")
        f = sync_collective_bytes(m, 2000 * m, mode="flat")
        want = (coll[f"flat{m}"]["all-gather"]
                / coll[f"hierarchical{m}"]["collective-permute"])
        assert want == 2 * m
        assert f["all_gather"]["cross_cluster"] / h["p2p"][
            "cross_cluster"] == want
    # the count is what the seam logged while the gloo world ran the syncs
    for mode, want in (("hierarchical", hier), ("flat", flat)):
        logged: dict = {}
        for res in gloo_runs[n]:
            for kind, d in res[f"{mode}_bytes"].items():
                t = logged.setdefault(kind, dict.fromkeys(d, 0))
                for k, v in d.items():
                    t[k] += v
        assert logged == want, mode


def test_make_sync_mesh_refuses_other_worlds(gloo_runs):
    from repro_torch.sync import make_sync_mesh
    for n in NS:
        for res in gloo_runs[n]:
            assert res["refused"] == [n - 1, n + 1]
    with pytest.raises(RuntimeError, match="needs a world of 4 ranks"):
        make_sync_mesh(2, "cpu")           # no world at all here


def test_sync_params_between_jobs_aliases():
    from repro_torch.sync import sync_params_between_jobs
    train = {"w": torch.ones(3), "layers": [{"a": torch.ones(2)},
                                            {"a": torch.full((2,), 2.0)}]}
    rollout = {"layers": [{"a": torch.zeros(2)}, {"a": torch.zeros(2)}],
               "w": torch.zeros(3)}
    out = sync_params_between_jobs(train, rollout)
    assert list(out) == list(rollout)
    assert out["w"] is train["w"]
    assert all(out["layers"][i]["a"] is train["layers"][i]["a"]
               for i in range(2))
    with pytest.raises(ValueError, match="structure"):
        sync_params_between_jobs(train, {"w": torch.zeros(3)})


def _round_trip(model):
    from repro_torch.sync import flatten_params, unflatten_params
    from repro_torch.train.optimizer import tree_leaves
    params = model.init(torch.Generator().manual_seed(0))
    flat = flatten_params(params)
    leaves = tree_leaves(params)
    assert flat.dim() == 1 and flat.numel() == sum(t.numel() for t in leaves)
    like = model.init(torch.Generator().manual_seed(1))   # other weights
    back = unflatten_params(flat, like)
    got = tree_leaves(back)
    assert len(got) == len(leaves)
    for a, b, c in zip(got, leaves, tree_leaves(like)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.data_ptr() != c.data_ptr()
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.contiguous().view(-1).view(torch.uint8))
    return flat, params


@pytest.mark.parametrize("arch", list_archs())
def test_flatten_round_trip(arch):
    from repro_torch.models import build_model
    flat, _ = _round_trip(build_model(arch, reduced=True))
    assert flat.dtype == torch.float32


def test_flatten_round_trip_mixed_dtypes():
    """A bf16 zamba2 keeps A_log, D and dt_bias in float32: the flat model
    is float32 (the promoted dtype) and each leaf comes back in its own."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sync import unflatten_params
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              dtype="bfloat16")
    flat, params = _round_trip(build_model(cfg))
    assert flat.dtype == torch.float32
    mamba = params["layers"][0]["mamba"]
    assert mamba["A_log"].dtype == torch.float32
    assert mamba["in_proj"].dtype == torch.bfloat16
    # a sync's padded output lands as it is; a short one raises
    padded = torch.cat([flat, flat.new_zeros(3)])
    back = unflatten_params(padded, params)
    assert torch.equal(back["embed"], params["embed"])
    with pytest.raises(ValueError, match="shorter"):
        unflatten_params(flat[:-1], params)
