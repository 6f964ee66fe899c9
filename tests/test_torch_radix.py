"""Radix prefix sharing on the port against its own unshared engine and
the JAX package's.

The port's ``Engine`` (plain kernel versions on the CPU) and the JAX
package's on converted reduced-internlm2 weights, float32, paged KV with
4-token blocks:

* sharing engines equal the port's unshared engine bit for bit (tokens
  and logprobs, ``atol=0``) on bf16-free float and on int8 pools, at
  decode block 1 and 4; tokens equal the JAX engine's, logprobs within
  1e-4 (int8: the drift between the packages' unshared int8 runs plus
  2e-3, their pools differing by a quantizer step on rounding boundaries,
  ROADMAP §3), and the radix counters equal the JAX engine's;
* the untagged exact repeat + extension gives misses 1, hits 1, partial
  hits 1; namespaces isolate; a prompt's blocks are pinned under every
  sharer; sharing admits more group members at equal memory; a resumed
  episode's history registers;
* eviction under pressure, strict LRU and leaf first, gives the JAX
  index's ``eviction_log``, node ids, block ids and counters on the same
  random operations;
* tree export/import, and an engine round trip with int8 and a suspended
  handle mid-tree, held to the unshared int8 run;
* ``assign_shared`` interleavings give the JAX ``PagedSlotManager``'s
  tables, shared entries and reference counts, invariants checked after
  every operation;
* a snapshot that keeps a view of the pool (tail block) or of the logits
  buffer in place of a copy fails the comparison with the unshared run.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import PagedSlotManager as JaxPagedSlotManager  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve.blocks import BlockAllocator as JaxBlockAllocator  # noqa
from repro.serve.radix import RadixPrefixIndex as JaxIndex  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, PagedSlotManager,  # noqa
                               Request, blocks_for, run_trace)
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.blocks import BlockAllocator  # noqa: E402
from repro_torch.serve.radix import RadixPrefixIndex  # noqa: E402

ARCH = "internlm2-1.8b"
MAX_LEN, BS = 40, 4


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, build_model(ARCH, reduced=True), from_jax_params(
        jax.tree.map(np.asarray, jp))


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.int32)


def _group_prompts(group=3):
    """GRPO-shaped: two prompts (9 and 6 ids: full blocks and a partial
    tail), each ``group`` times, interleaved."""
    a, b = _prompt(0, 9), _prompt(1, 6)
    return [p for _ in range(group) for p in (a, b)]


def _cfg(cls, **kw):
    base = dict(num_slots=3, max_seq_len=MAX_LEN, temperature=0.0,
                kv_layout="paged", kv_block_size=BS)
    base.update(kw)
    return cls(**base)


def _serve(pair, prompts, *, jax_side=False, max_new=8, keys=None,
           engine=None, **kw):
    """``prompts`` through a new engine (or ``engine``); returns the engine
    and its outputs by rid."""
    jm, jp, tm, tp = pair
    req_cls = JaxRequest if jax_side else Request
    if engine is None:
        engine = (JaxEngine(jm, jp, _cfg(JaxEngineConfig, **kw)) if jax_side
                  else Engine(tm, tp, _cfg(EngineConfig, **kw),
                              device="cpu"))
    for i, p in enumerate(prompts):
        engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=max_new,
                              prefix_key=None if keys is None else keys[i]))
    outs = engine.run()
    return engine, {o.rid: o for o in outs}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, rid
        np.testing.assert_array_equal(np.asarray(a[rid].logprobs),
                                      np.asarray(b[rid].logprobs))


def _close(port, ref, atol):
    for rid in ref:
        assert port[rid].tokens == ref[rid].tokens, rid
        np.testing.assert_allclose(port[rid].logprobs, ref[rid].logprobs,
                                   atol=atol)


def _counters(radix):
    return (radix.hits, radix.partial_hits, radix.misses, radix.evictions)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("block_size", [1, 4])
def test_shared_matches_unshared_and_jax(pair, kv_dtype, block_size):
    prompts = _group_prompts()
    kw = dict(kv_dtype=kv_dtype, block_size=block_size)
    _, base = _serve(pair, prompts, **kw)
    eng, shared = _serve(pair, prompts, prefix_share=True, **kw)
    _same(shared, base)
    jeng, jshared = _serve(pair, prompts, jax_side=True, prefix_share=True,
                           **kw)
    tol = 1e-4
    if kv_dtype:
        # the packages' unshared int8 runs already drift apart (ROADMAP
        # §3): the shared ones are held to that drift plus 2e-3
        _, jbase = _serve(pair, prompts, jax_side=True, **kw)
        tol = 2e-3 + max(np.abs(np.subtract(base[r].logprobs,
                                            jbase[r].logprobs)).max()
                         for r in base)
    _close(shared, jshared, tol)
    assert _counters(eng.radix) == _counters(jeng.radix) == (4, 0, 2, 0)
    assert eng.metrics().prefix_hits == 4 and eng.metrics().prefills == 6
    assert eng.metrics().blocks_saved == jeng.metrics().blocks_saved > 0
    eng.slots.check(extra_pins=eng.radix.pinned_blocks())
    eng.reset()                              # flushes; asserts a clean pool
    assert len(eng.radix) == 0


def test_untagged_exact_repeat_and_extension(pair):
    """No keys: the exact repeat admits with no compute, the extension
    pins the common full blocks; probes do not move the counters."""
    p = _prompt(2, 10)
    prompts = [p, p.copy(), np.concatenate([p, [9, 9, 9]]).astype(np.int32)]
    _, base = _serve(pair, prompts, max_new=5)
    eng, outs = _serve(pair, prompts, max_new=5, prefix_share=True)
    _same(outs, base)
    jeng, jouts = _serve(pair, prompts, jax_side=True, max_new=5,
                         prefix_share=True)
    _close(outs, jouts, 1e-4)
    assert (eng.radix.misses, eng.radix.hits, eng.radix.partial_hits) == \
        (1, 1, 1) == (jeng.radix.misses, jeng.radix.hits,
                      jeng.radix.partial_hits)
    assert eng.metrics().blocks_saved >= 2 * (len(p) // BS)
    assert outs[2].prefix_shared_blocks == len(p) // BS
    before = dict(eng.radix.stats)
    assert eng.radix.match(Request(rid=9, prompt=p, max_new_tokens=1))
    assert dict(eng.radix.stats) == before
    # the extension registered in turn: its repeat is an exact hit
    assert eng.radix.match(Request(rid=9, prompt=prompts[2],
                                   max_new_tokens=1)).exact


def test_namespace_isolation(pair):
    p = _prompt(3, 9)
    eng, outs = _serve(pair, [p] * 3, max_new=4, prefix_share=True,
                       keys=("tenant-a", "tenant-b", None))
    assert (eng.radix.hits, eng.radix.partial_hits, eng.radix.misses) == \
        (0, 0, 3)
    assert len(eng.radix.roots) == 3 and len(eng.radix) == 3 * (9 // BS)
    assert outs[0].tokens == outs[1].tokens == outs[2].tokens
    eng.slots.check(extra_pins=eng.radix.pinned_blocks())


def test_blocks_pinned_under_several_owners(pair):
    jm, jp, tm, tp = pair
    p = _prompt(4, 10)
    eng = Engine(tm, tp, _cfg(EngineConfig, prefix_share=True), device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    eng.step()                               # all three admitted
    probe = eng.radix.match(Request(rid=9, prompt=p, max_new_tokens=1))
    assert probe.exact and len(probe.block_ids) == 2
    for bid in probe.block_ids:
        # the donor's own reference, two sharers' and the tree's pin
        assert eng.slots.alloc.refcount[bid] == 4
    assert eng.slots.shared == {1: probe.block_ids, 2: probe.block_ids}
    eng.slots.check(extra_pins=eng.radix.pinned_blocks())
    eng.run()
    for bid in probe.block_ids:
        assert eng.slots.alloc.refcount[bid] == 1       # the tree's alone


def test_more_group_members_at_equal_memory(pair):
    p = _prompt(5, 10)
    blocks = 3 * blocks_for(10 + 8, BS)      # three unshared members' need
    kw = dict(num_slots=6, num_kv_blocks=blocks)
    unshared, base = _serve(pair, [p] * 6, **kw)
    shared, outs = _serve(pair, [p] * 6, prefix_share=True, **kw)
    assert shared.metrics().peak_active > unshared.metrics().peak_active
    _same(outs, base)


@pytest.mark.parametrize("tool", [(7, 11, 13), ()])
def test_multi_turn_resume_history_registers(pair, tool):
    """A resumed episode's history (prompt, its turn, the tool's reply)
    registers once its slot holds it: a sibling submitting that history
    is an exact hit and continues as the resume did."""
    jm, jp, tm, tp = pair
    p = _prompt(6, 5)
    ref = _serve(pair, [p], max_new=10)[1][0].tokens
    eng = Engine(tm, tp, _cfg(EngineConfig, num_slots=2, prefix_share=True),
                 device="cpu")
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=10,
                       stop_tokens=(ref[2],)))
    eng.run()
    [sreq] = eng.harvest_suspended()
    eng.resume(sreq, tool, max_new_tokens=6, rid=1, stop_tokens=())
    resumed = eng.run()[-1]
    history = np.concatenate([p, np.asarray(sreq.out.tokens, np.int32),
                              np.asarray(tool, np.int32)])
    sib = Request(rid=2, prompt=history, max_new_tokens=6)
    assert eng.radix.match(sib).exact
    hits = eng.radix.hits
    eng.submit(sib)
    eng.run()
    assert eng.radix.hits == hits + 1
    assert eng.finished[2].tokens == resumed.tokens
    np.testing.assert_array_equal(eng.finished[2].logprobs,
                                  resumed.logprobs)
    eng.slots.check(extra_pins=eng.radix.pinned_blocks())


def test_eviction_under_pressure_and_reset_flush(pair):
    jm, jp, tm, tp = pair
    eng = Engine(tm, tp, _cfg(EngineConfig, num_slots=2, prefix_share=True,
                              num_kv_blocks=blocks_for(MAX_LEN, BS)),
                 device="cpu")
    probe = Request(rid=9, prompt=_prompt(7, 9), max_new_tokens=4)
    eng.submit(Request(rid=0, prompt=probe.prompt, max_new_tokens=4))
    eng.run()
    assert len(eng.radix) == 2 and eng.radix.match(probe) is not None
    # an unrelated request needs the whole pool: the path goes
    eng.submit(Request(rid=1, prompt=_prompt(8, 4), max_new_tokens=36))
    eng.run()
    assert eng.radix.evictions == 2 and eng.radix.match(probe) is None
    assert eng.metrics().prefix_evictions == 2
    eng.reset()
    assert len(eng.radix) == 0 and eng.slots.blocks_in_use == 0


# ---------------------------------------------------------------------------
# the index against the JAX package's: strict LRU, leaf first, same ops
# ---------------------------------------------------------------------------
def _register_blocks(index, alloc, owner, tokens, key=None, cls=Request):
    """Register a block-aligned prompt whose blocks a transient owner
    allocated, as a donor slot would."""
    req = cls(rid=0, prompt=np.asarray(tokens, np.int32), max_new_tokens=1,
              prefix_key=key)
    n = len(tokens) // alloc.block_size
    alloc.reserve(owner, n)
    bids = [alloc.allocate(owner) for _ in range(n)]
    index.register(req, bids, logits=None, tail={}, slot_leaves={})
    alloc.free_all(owner)
    return req


def test_evict_for_strict_lru_order():
    alloc = BlockAllocator(8, 4)
    index = RadixPrefixIndex(alloc)
    reqs = {n: _register_blocks(index, alloc, i, t) for i, (n, t) in
            enumerate((("a", [1, 2, 3, 4]), ("b", [5, 6, 7, 8]),
                       ("c", [9, 10, 11, 12])))}
    ids = {n: index.match(r).node_ids[0] for n, r in reqs.items()}
    index.touch(index.match(reqs["a"]))      # A the most recent
    assert index.evict_for(8)
    assert index.eviction_log == [ids["b"], ids["c"], ids["a"]]
    alloc.assert_clean()


def test_evict_for_leaf_first_and_protect():
    alloc = BlockAllocator(8, 4)
    index = RadixPrefixIndex(alloc)
    r = _register_blocks(index, alloc, 1, list(range(1, 9)))
    parent, child = index.match(r).nodes
    assert not index.evict_for(8, protect=index.match(r).node_ids)
    assert index.eviction_log == []
    alloc.incref(parent.block_id)            # a live sharer of the parent
    assert not index.evict_for(8)
    assert index.eviction_log == [child.node_id]
    alloc.decref(parent.block_id)
    assert index.evict_for(8)
    assert index.eviction_log == [child.node_id, parent.node_id]
    alloc.assert_clean()


def _index_state(index):
    return (list(index.eviction_log), dict(index.stats),
            sorted((n.node_id, n.parent.node_id, n.block_id, n.last_used)
                   for n in index.nodes.values()))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_index_ops_match_jax(seed):
    """Random register / counted match / touch / pin / unpin / evict_for
    / demote operations on the port's index and the JAX index, each over
    its own allocator: the same eviction log, node ids, block ids, LRU
    clocks and counters after every operation."""
    rs = np.random.RandomState(seed)
    sides = [(RadixPrefixIndex, BlockAllocator, Request),
             (JaxIndex, JaxBlockAllocator, JaxRequest)]
    built = []
    for idx_cls, alloc_cls, req_cls in sides:
        alloc = alloc_cls(24, 4)
        built.append((idx_cls(alloc), alloc, req_cls))
    pins, owner = [], 100
    for _ in range(60):
        op = rs.randint(6)
        toks = rs.randint(0, 3, size=4 * rs.randint(1, 4) + rs.randint(3))
        key = rs.choice([None, "ns"])
        if op == 0:
            n = len(toks) // 4
            if not built[0][1].can_reserve(n):
                continue
            owner += 1
            for index, alloc, req_cls in built:
                _register_blocks(index, alloc, owner, toks[:4 * n], key,
                                 req_cls)
        elif op == 1:
            for index, alloc, req_cls in built:
                m = index.match(req_cls(rid=0, prompt=toks, max_new_tokens=1,
                                        prefix_key=key), count=True)
                if m is not None and rs.rand() < 0.5 + 0 * len(pins):
                    index.touch(m)
        elif op == 2 and built[0][0].nodes:
            nid = sorted(built[0][0].nodes)[rs.randint(len(built[0][0]))]
            pins.append(nid)
            for index, alloc, _ in built:
                alloc.incref(index.nodes[nid].block_id)
        elif op == 3 and pins:
            nid = pins.pop(rs.randint(len(pins)))
            for index, alloc, _ in built:
                alloc.decref(index.nodes[nid].block_id)
        elif op == 4:
            want = int(rs.randint(1, 25))
            protect = [n for n in sorted(built[0][0].nodes)
                       if rs.rand() < 0.2]
            got = [index.evict_for(want, protect=protect)
                   for index, _, _ in built]
            assert got[0] == got[1]
            pins = [n for n in pins if n in built[0][0].nodes]
        elif op == 5:
            ttl = int(rs.randint(0, 6))
            assert built[0][0].demote_stale(ttl) == \
                built[1][0].demote_stale(ttl)
        assert _index_state(built[0][0]) == _index_state(built[1][0])
        assert built[0][1].refcount == built[1][1].refcount
        assert built[0][1].free == built[1][1].free
    assert built[0][0].export_host_state()["counters"] == \
        built[1][0].export_host_state()["counters"]


def test_tree_export_import_roundtrip():
    alloc = BlockAllocator(16, 4)
    index = RadixPrefixIndex(alloc)
    ra = _register_blocks(index, alloc, 1, [1, 2, 3, 4, 5, 6, 7, 8])
    rb = _register_blocks(index, alloc, 2, [1, 2, 3, 4, 9, 9, 9, 9])
    rc = Request(rid=0, prompt=[20, 21, 22, 23, 5], max_new_tokens=1,
                 prefix_key="ns")
    alloc.reserve(3, 1)
    index.register(rc, [alloc.allocate(3)], logits=torch.arange(4.0),
                   tail={"k": torch.ones(2)},
                   slot_leaves={"s": torch.zeros(3)})
    alloc.free_all(3)
    index.match(ra, count=True)
    index.touch(index.match(ra))
    clone = RadixPrefixIndex(alloc)
    clone.import_state(index.export_host_state(),
                       index.export_device_state())
    assert set(clone.roots) == {None, "ns"} and len(clone) == len(index)
    for req in (ra, rb, rc):
        a, b = index.match(req), clone.match(req)
        assert (a.node_ids, a.block_ids, a.exact) == \
            (b.node_ids, b.block_ids, b.exact)
    assert clone.match(ra).node_ids[0] == clone.match(rb).node_ids[0]
    snap = clone.match(rc).snapshot
    assert torch.equal(snap.logits, torch.arange(4.0))
    assert torch.equal(snap.tail["k"], torch.ones(2))
    assert clone.stats == index.stats and clone._tick == index._tick
    index.flush()
    alloc.assert_clean()


def test_engine_roundtrip_int8_with_suspended_handle_mid_tree(pair):
    """Export with a populated tree (int8 scales in the pool) and a
    suspended handle pinning blocks mid-tree; the importing engine's exact
    hit and resume equal the unshared int8 run's tokens."""
    jm, jp, tm, tp = pair
    kw = dict(num_slots=2, kv_dtype="int8")
    p = _prompt(9, 10)
    ref = _serve(pair, [p], max_new=8, **kw)[1][0]
    eng = Engine(tm, tp, _cfg(EngineConfig, prefix_share=True, **kw),
                 device="cpu")
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=8))
    eng.run()
    eng.submit(Request(rid=1, prompt=p, max_new_tokens=8,
                       stop_tokens=(ref.tokens[2],)))
    eng.run()
    [sreq] = eng.harvest_suspended()
    n0 = len(sreq.out.tokens)
    state = eng.export_state()
    fresh = Engine(tm, tp, _cfg(EngineConfig, prefix_share=True, **kw),
                   device="cpu")
    fresh.import_state(state)
    a, b = eng.radix.export_host_state(), fresh.radix.export_host_state()
    assert a["counters"] == b["counters"]
    assert [(n["id"], n["parent"], n["block_id"]) for n in a["nodes"]] == \
        [(n["id"], n["parent"], n["block_id"]) for n in b["nodes"]]
    fresh.submit(Request(rid=2, prompt=p, max_new_tokens=8))
    fresh.run()
    assert fresh.radix.hits == eng.radix.hits + 1
    assert fresh.finished[2].tokens == ref.tokens
    np.testing.assert_array_equal(fresh.finished[2].logprobs, ref.logprobs)
    fresh.resume(fresh.suspended[1], (), max_new_tokens=5, rid=3,
                 stop_tokens=())
    fresh.run()
    assert fresh.finished[3].tokens == ref.tokens[n0:n0 + 5]
    fresh.slots.check(extra_pins=fresh.radix.pinned_blocks())
    sreq.release()


def test_export_import_with_live_shared_slots(pair):
    jm, jp, tm, tp = pair
    p = _prompt(10, 9)
    cfg = _cfg(EngineConfig, num_slots=2, prefix_share=True)
    eng = Engine(tm, tp, cfg, device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    eng.step()
    eng.step()                               # shared slots live, 1 waiting
    assert eng.slots.shared
    other = Engine(tm, tp, cfg, device="cpu")
    other.import_state(eng.export_state())
    _same({o.rid: o for o in other.run()}, {o.rid: o for o in eng.run()})
    other.slots.check(extra_pins=other.radix.pinned_blocks())


# ---------------------------------------------------------------------------
# assign_shared interleavings against the JAX slot manager
# ---------------------------------------------------------------------------
def _slot_ops(seed, n=80):
    rs = np.random.RandomState(seed)
    return [(int(rs.randint(6)), int(rs.randint(64))) for _ in range(n)]


def _drive(sm, ops):
    """Random admit / shared admit / grow / pin / unpin / finish; yields
    the manager's state after every operation."""
    live, pins, rid = [], [], 0
    for kind, val in ops:
        if kind == 0:
            plen = 1 + val % 10
            budget = plen + 1 + val % 12
            if sm.can_admit(budget):
                live.append((sm.assign(rid, prompt_len=plen,
                                       total_budget=budget), plen, budget))
                rid += 1
        elif kind == 1 and live:
            dslot, dplen, _ = live[val % len(live)]
            n_full = min(dplen // sm.block_size, sm.nblocks[dslot])
            shared = [int(b) for b in sm.tables[dslot, :n_full]]
            plen = max(dplen, 1 + val % 10)
            budget = plen + 1 + val % 12
            if sm.can_admit(budget, shared_blocks=len(shared)):
                live.append((sm.assign_shared(
                    rid, prompt_len=plen, total_budget=budget,
                    shared_ids=shared), plen, budget))
                rid += 1
        elif kind == 2 and live:
            slot, plen, budget = live[val % len(live)]
            sm.ensure(slot, min(plen + val % 8, budget - 1))
        elif kind == 3 and live:
            dslot, dplen, _ = live[val % len(live)]
            for b in sm.tables[dslot, :min(dplen // sm.block_size,
                                           sm.nblocks[dslot])]:
                sm.alloc.incref(int(b))
                pins.append(int(b))
        elif kind == 4 and pins:
            sm.alloc.decref(pins.pop(val % len(pins)))
        elif kind == 5 and live:
            sm.release(live.pop(val % len(live))[0])
        sm.check(extra_pins=pins)
        yield (sm.tables.tolist(), list(sm.nblocks), dict(sm.shared),
               dict(sm.alloc.refcount), list(sm.alloc.free),
               list(sm.free))
    for slot, _, _ in live:
        sm.release(slot)
    while pins:
        sm.alloc.decref(pins.pop())
    sm.check()
    assert sm.blocks_in_use == 0 and sm.num_free == sm.num_slots
    yield None


@pytest.mark.parametrize("seed,bs,nb", [(0, 4, 24), (1, 2, 16), (2, 3, 12),
                                        (3, 5, 32)])
def test_assign_shared_interleavings_match_jax(pair, seed, bs, nb):
    jm, _, tm, _ = pair
    ops = _slot_ops(seed)
    port = _drive(PagedSlotManager(tm, 5, MAX_LEN, block_size=bs,
                                   num_blocks=nb, device="cpu"), ops)
    ref = _drive(JaxPagedSlotManager(jm, 5, MAX_LEN, block_size=bs,
                                     num_blocks=nb), ops)
    for step, (a, b) in enumerate(zip(port, ref)):
        assert a == b, step


# ---------------------------------------------------------------------------
# a planted view in place of a snapshot copy must fail
# ---------------------------------------------------------------------------
def _viewing_register(self, req, slot):
    """``Engine._register_prefix`` with views of the pool and of the
    logits buffer in place of copies (the planted fault)."""
    bs = self.config.kv_block_size
    n_full = req.prompt_len // bs
    pid = int(self.slots.tables[slot, n_full])
    tail = ({name: leaf[:, pid] for name, leaf in self.slots.cache.items()
             if name != "index"} if req.prompt_len % bs else {})
    self.radix.register(
        req, [int(b) for b in self.slots.tables[slot, :n_full]],
        logits=self._last_logits[slot], tail=tail, slot_leaves={})


def test_planted_snapshot_views_fail(pair, monkeypatch):
    """A donor runs out, an unrelated request reuses its freed tail block
    and slot, then the donor's prompt repeats as an exact hit: seeded from
    views, the hit reads the other request's KV and logits and leaves the
    unshared run; seeded from copies, it equals it bit for bit."""
    p, q = _prompt(11, 10), _prompt(12, 10)
    kw = dict(num_slots=1, max_new=6)
    _, base = _serve(pair, [p, q, p], **kw)
    _, shared = _serve(pair, [p, q, p], prefix_share=True, **kw)
    _same(shared, base)
    monkeypatch.setattr(engine_mod.Engine, "_register_prefix",
                        _viewing_register)
    _, planted = _serve(pair, [p, q, p], prefix_share=True, **kw)
    assert planted[2].tokens != base[2].tokens or not np.array_equal(
        planted[2].logprobs, base[2].logprobs)


def test_refusals_and_trace_report(pair):
    jm, jp, tm, tp = pair
    with pytest.raises(ValueError, match="prefix_share"):
        EngineConfig(prefix_share=True, kv_layout="contiguous")
    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        m = build_model(arch, reduced=True)
        e = Engine(m, m.init(torch.Generator().manual_seed(0)),
                   _cfg(EngineConfig, prefix_share=True), device="cpu")
        assert e.radix is not None and not len(e.radix)
    eng = Engine(tm, tp, _cfg(EngineConfig, prefix_share=True),
                 device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4, arrival_time=0.0)
            for i, p in enumerate(_group_prompts(2))]
    rep = run_trace(eng, reqs, realtime=False)
    assert rep["prefix"]["hits"] == 2 and rep["prefix"]["misses"] == 2
    assert rep["prefix"]["hit_admits"] == 2
    assert rep["prefix"]["blocks_saved"] == eng.metrics().blocks_saved
    m = eng.metrics()
    assert (m.prefix_misses, m.pinned_blocks) == (2, len(eng.radix))
