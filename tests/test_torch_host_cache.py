"""The port's host-memory actor cache and disk checkpoints against the JAX
package's (``tests/test_runtime.py``, ``tests/test_optimizer.py``).

On the CPU the cache copies through ordinary host tensors, as the JAX
package's does; the page-locked buffers of a CUDA state are the chip
smoke's to check (``chip_smoke.py``, mux phase).  Both caches get the same
numpy trees, and every count they report must agree: warm hits, cold
misses, offloads, ``used_bytes``, ``can_admit``, ``evict``.  The trees are
float32 where they go through a JAX warm start (which, with 64-bit mode
off, turns float64 into float32).
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro.core.phase_control import RollMuxRuntime as JRuntime  # noqa: E402
from repro.train.checkpoints import HostStateCache as JCache  # noqa: E402
from repro.train.checkpoints import load_checkpoint as jload  # noqa: E402
from repro.train.checkpoints import save_checkpoint as jsave  # noqa: E402
from repro_torch.core import RollMuxRuntime  # noqa: E402
from repro_torch.train.checkpoints import (HostStateCache,  # noqa: E402
                                           load_checkpoint, save_checkpoint)


def np_tree():
    rs = np.random.RandomState(0)
    return {"w": np.arange(100, dtype=np.float32),
            "b": {"x": np.ones((3, 3), np.float32),
                  "y": rs.randn(4, 5).astype(np.float32)},
            "layers": [{"k": rs.randn(2, 3).astype(np.float32)},
                       {"k": rs.randn(2, 3).astype(np.float32)}],
            "step": np.asarray(7, dtype=np.int32)}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_host_cache_roundtrip_matches_jax():
    """``tests/test_runtime.py::test_host_cache_roundtrip`` on both caches."""
    tree = np_tree()
    caches = (JCache(capacity_bytes=1 << 30),
              HostStateCache(capacity_bytes=1 << 30))
    outs = []
    for cache, t in zip(caches, (tree, to_torch(tree))):
        cache.offload("job1/train", t)
        out, dt = cache.restore("job1/train")
        assert dt >= 0
        missing, dt_miss = cache.restore("nope")
        assert missing is None and dt_miss == 0.0
        assert cache.stats["warm_hits"] == 1
        assert cache.stats["cold_misses"] == 1
        outs.append(out)
    assert_tree_equal(outs[1], tree)
    assert_tree_equal(outs[1], jax_tree_to_np(outs[0], tree))
    assert caches[0].stats == caches[1].stats


def jax_tree_to_np(out, like):
    """The JAX cache restores dict keys sorted (a jax treedef); reorder them
    as ``like`` has them."""
    if isinstance(like, dict):
        return {k: jax_tree_to_np(out[k], like[k]) for k in like}
    if isinstance(like, list):
        return [jax_tree_to_np(o, w) for o, w in zip(out, like)]
    return np.asarray(out)


def test_restore_is_a_copy():
    """Changing a restored tensor changes neither the cache nor the tree
    that was offloaded, and neither changes the other after the offload."""
    cache = HostStateCache(1 << 20)
    t = to_torch(np_tree())
    cache.offload("k", t)
    t["w"].add_(1.0)
    out, _ = cache.restore("k")
    np.testing.assert_array_equal(out["w"].numpy(), np_tree()["w"])
    out["w"].mul_(0.0)
    again, _ = cache.restore("k")
    np.testing.assert_array_equal(again["w"].numpy(), np_tree()["w"])


def test_used_bytes_admit_evict_match_jax():
    trees = [np_tree(), {"a": np.zeros((10, 10), np.float64)},
             {"h": np.ones(17, np.float16), "i": np.arange(3, dtype=np.int64)}]
    sizes = [sum(np.asarray(x).nbytes for x in _np_leaves(t)) for t in trees]
    cap = sizes[0] + sizes[1] + 8
    jc, tc = JCache(cap), HostStateCache(cap)
    for cache, conv in ((jc, lambda t: t), (tc, to_torch)):
        assert cache.used_bytes() == 0
        cache.offload("a", conv(trees[0]))
        assert cache.used_bytes() == sizes[0]
        assert cache.can_admit(sizes[1])
        cache.offload("b", conv(trees[1]))
        assert cache.used_bytes() == sizes[0] + sizes[1]
        assert not cache.can_admit(sizes[2])
        cache.offload("a", conv(trees[2]))       # a new state under "a"
        assert cache.used_bytes() == sizes[2] + sizes[1]
        assert cache.resident("a") and cache.resident("b")
        cache.evict("a")
        cache.evict("never-offloaded")
        assert not cache.resident("a")
        assert cache.used_bytes() == sizes[1]
        assert cache.can_admit(sizes[0])
        assert cache.restore("a")[0] is None
    assert jc.stats == tc.stats
    assert jc.used_bytes() == tc.used_bytes()


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _np_leaves(t)]
    return [tree]


def test_offload_across_devices_raises():
    cache = HostStateCache(1 << 20)
    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="spans devices"):
        cache.offload("k", {"a": torch.zeros(3), "b": meta})


def _interleave(rt, make_state, add):
    """``tests/test_runtime.py::test_runtime_phases_interleave_and_warm_
    start``: two jobs' phases through the runtime ``rt``."""
    rt.pool("rollout", 1)
    rt.pool("train", 1)
    events = []

    @rt.runtime_hook
    def trace(job, phase, ev):
        events.append((job, phase, ev))

    def make_phases():
        @rt.phase("rollout", name="roll", init_fn=lambda: {"n": make_state()})
        def roll(state):
            time.sleep(0.01)
            return {"n": add(state["n"], 1)}, float(state["n"].sum())

        @rt.phase("train", name="train", init_fn=lambda: {"w": make_state()})
        def train(state, x):
            time.sleep(0.01)
            return {"w": add(state["w"], x)}, None
        return roll, train

    def job_loop(jid, iters=3):
        roll, train = make_phases()
        for _ in range(iters):
            out = roll(jid)
            train(jid, out)

    ts = [threading.Thread(target=job_loop, args=(f"j{i}",)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    return events


def test_runtime_phases_interleave_and_warm_start_match_jax():
    jrt, trt = JRuntime(host_cache_gb=1.0), RollMuxRuntime(host_cache_gb=1.0)
    # float32: the JAX cache's warm start canonicalises float64 to float32
    jev = _interleave(jrt, lambda: np.zeros(4, np.float32),
                      lambda a, x: a + x)
    tev = _interleave(trt, lambda: torch.zeros(4), lambda a, x: a + x)
    assert sorted(jev) == sorted(tev)
    for jid in ("j0", "j1"):
        for ph in ("roll", "train"):
            js, ts = jrt.stats[f"{jid}:{ph}"], trt.stats[f"{jid}:{ph}"]
            assert (ts.runs, ts.cold_starts, ts.warm_starts) == (
                js.runs, js.cold_starts, js.warm_starts) == (3, 1, 2)
    for pool in ("rollout", "train"):
        users = {w.split(":")[0] for w, _, _ in trt.pools[pool].timeline}
        assert users == {"j0", "j1"}
    assert jrt.cache.stats == trt.cache.stats
    assert jrt.cache.used_bytes() == trt.cache.used_bytes()
    for key in ("j0/rollout", "j1/rollout", "j0/train", "j1/train"):
        jout, _ = jrt.cache.restore(key)
        tout, _ = trt.cache.restore(key)
        (name,) = tout
        np.testing.assert_array_equal(tout[name].numpy(),
                                      np.asarray(jout[name]))
    final, _ = trt.cache.restore("j0/rollout")
    assert final["n"].sum() == 12  # 3 increments x 4 elems


def test_checkpoint_roundtrip_matches_jax(tmp_path):
    """``tests/test_optimizer.py::test_checkpoint_roundtrip`` through both
    packages' save/load on the same numpy tree."""
    tree = np_tree()
    jsave(str(tmp_path / "j" / "ck.pkl"), tree)
    save_checkpoint(str(tmp_path / "t" / "ck.pt"), to_torch(tree))
    jout = jload(str(tmp_path / "j" / "ck.pkl"))
    tout = load_checkpoint(str(tmp_path / "t" / "ck.pt"))
    assert_tree_equal(tout, tree)
    assert_tree_equal(tout, jax_tree_to_np(jout, tree))
    assert all(t.device.type == "cpu" for t in _np_leaves(tout))


class FakeCudart:
    """Stands in for ``torch.cuda.cudart()``: records the calls and
    answers each registration with ``register_rc``."""

    class cudaError:  # noqa: N801 - mirrors the binding's enum
        success = 0

    def __init__(self, register_rc=0):
        self.register_rc = register_rc
        self.calls = []

    def cudaHostRegister(self, ptr, nbytes, flags):  # noqa: N802
        self.calls.append(("register", ptr, nbytes))
        return self.register_rc

    def cudaHostUnregister(self, ptr):  # noqa: N802
        self.calls.append(("unregister", ptr))
        return 0


def test_pinning_that_fails_raises(monkeypatch):
    from repro_torch.train import checkpoints as ck
    fake = FakeCudart(register_rc=2)
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    with pytest.raises(RuntimeError, match="no pageable fallback"):
        ck._PinnedBuffer(4096, "'job0/train'")
    assert [c[0] for c in fake.calls] == ["register"]


def test_pinned_buffer_layout_and_release(monkeypatch):
    """The buffer is registered once at its exact size, each leaf is a
    256-byte aligned view of it with the leaf's shape and dtype, and it is
    unregistered once."""
    from repro_torch.train import checkpoints as ck
    fake = FakeCudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    leaves = ck.tree_leaves(to_torch(np_tree()))
    entry = ck._pinned_entry(leaves, torch.device("cpu"), "'k'")
    sizes = [t.numel() * t.element_size() for t in leaves]
    assert entry.nbytes == sum(-(-n // 256) * 256 for n in sizes)
    (_, ptr, nbytes), = fake.calls
    assert (ptr, nbytes) == (entry.buffer.tensor.data_ptr(), entry.nbytes)
    for view, leaf in zip(entry.leaves, leaves):
        assert (view.shape, view.dtype) == (leaf.shape, leaf.dtype)
        assert (view.data_ptr() - ptr) % 256 == 0
        view.copy_(leaf)
    assert_tree_equal(ck._rebuild(to_torch(np_tree()), entry.leaves),
                      np_tree())
    entry.release()
    entry.release()
    assert fake.calls[1:] == [("unregister", ptr)]


class FakeEvent:
    """Stands in for the CUDA event after a restore's copies: records when
    it is waited for in the fake ``cudart``'s call log."""

    def __init__(self, calls):
        self.calls = calls

    def synchronize(self):
        self.calls.append(("wait",))


@pytest.mark.parametrize("how", ["evict", "collected"])
def test_pinned_buffer_waits_for_the_last_restore(monkeypatch, how):
    """A buffer a restore still reads is unpinned only after the restore's
    event, whether the cache evicts its entry or is collected with the
    copy in flight (the registered memory is not PyTorch's, so a queued
    copy does not keep it alive)."""
    import gc
    from repro_torch.train import checkpoints as ck
    fake = FakeCudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    leaves = ck.tree_leaves(to_torch(np_tree()))
    cache = ck.HostStateCache(1 << 30)
    entry = ck._pinned_entry(leaves, torch.device("cpu"), "'k'")
    ptr = entry.buffer.tensor.data_ptr()
    entry.buffer.last_read = FakeEvent(fake.calls)
    cache._put("job0/train", entry)
    del entry
    if how == "evict":
        cache.evict("job0/train")
    else:
        del cache
        gc.collect()
    assert fake.calls[1:] == [("wait",), ("unregister", ptr)]
