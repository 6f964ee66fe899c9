"""The port's roofline module and cost walk against the JAX package's.

* ``model_flops_for`` equals the reference's for every arch x shape.
* Each kernel wrapper's meta case, on plain meta tensors inside a walk,
  returns outputs of the right shapes and dtypes, computes nothing, leaves
  the wrapper's launch counter alone and records one launch with its
  bound's operations and bytes (``kernels.work``); on meta it validates as
  on CUDA.
* A one-rank walk of a reduced internlm2-1.8b train step (2 microbatches,
  remat) and prefill: the walk's aten product FLOPs, less those of flash
  attention's plain backward, equal the reference's HLO-walk dot FLOPs
  (``analyze_hlo`` of the jitted reference function) less its attention
  products, exactly (tolerance 0: both count 2 x M x N x K a product); the
  reference's attention products are 16 full S x S squares a layer of the
  train step (forward, its remat recompute, four backward products: plain
  jnp attention) and 4 of the prefill, the port's plain backward 10 full
  squares a layer (the score recompute and four products over the
  causal chunk, which at S <= 1024 is the whole square), and the flash
  kernel's recorded operations the causal half, 2 (D + Dv) a visible
  pair, once a layer and microbatch in the prefill and twice (forward and
  recompute) in the train step.
* In a spawned process holding a fake 256-rank world on a (16, 16) mesh:
  a product sharded over both axes counts global / 256 a rank, a
  replicated one the global count, a ``redistribute`` to ``Replicate``
  its all-gather's bytes; a flash call on ``DTensor``\\ s sharded on batch
  and heads returns a ``DTensor`` in q's placements and records the local
  shards' work.
"""
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import list_archs  # noqa: E402


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch,shape",
                         [(a, s) for a in list_archs() for s in REF_SHAPES])
def test_model_flops_for_equals_the_reference(arch, shape):
    from repro.configs import get_config as ref_config
    from repro.launch.roofline import model_flops_for as ref_mf

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.roofline import model_flops_for
    assert model_flops_for(get_config(arch), SHAPES[shape]) == \
        ref_mf(ref_config(arch), REF_SHAPES[shape])


def _kernel_cases():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import sampling as sp
    from repro_torch.kernels import work
    f32 = torch.float32
    B, S, H, Hkv, D = 2, 96, 16, 8, 128
    yield ("flash_attention", fa.flash_attention,
           lambda: fa.flash_attention(meta((B, S, H, D)), meta((B, S, Hkv, D)),
                                      meta((B, S, Hkv, D)), return_lse=True),
           [((B, S, H, D), torch.bfloat16), ((B, H, S), f32)],
           work.flash_attention_work(B, S, H, Hkv, D, D))
    yield ("flash_attention", fa.flash_attention,
           lambda: fa.flash_attention(meta((1, 300, 4, 192)),
                                      meta((1, 300, 4, 192)),
                                      meta((1, 300, 4, 128)), window=64),
           [((1, 300, 4, 128), torch.bfloat16)],
           work.flash_attention_work(1, 300, 4, 4, 192, 128, window=64))
    Sd = 1024
    yield ("decode_attention", da.decode_attention,
           lambda: da.decode_attention(meta((8, H, D)), meta((8, Sd, Hkv, D)),
                                       meta((8, Sd, Hkv, D)),
                                       meta((8,), torch.int32)),
           [((8, H, D), torch.bfloat16)],
           work.decode_attention_work(8, H, Hkv, D, 8 * Sd))
    NB, bs, MB = 65, 16, 64
    yield ("paged_decode_attention", da.paged_decode_attention,
           lambda: da.paged_decode_attention(
               meta((8, H, D)), meta((NB, bs, Hkv, D), torch.int8),
               meta((NB, bs, Hkv, D), torch.int8), meta((8, MB), torch.int32),
               meta((8,), torch.int32), window=500,
               k_scale=meta((NB, bs), f32), v_scale=meta((NB, bs), f32)),
           [((8, H, D), torch.bfloat16)],
           work.decode_attention_work(8, H, Hkv, D, 8 * 500, kv_elem=1,
                                      quantized=True, table_entries=8 * MB))
    V = 92544
    yield ("greedy_sample", sp.greedy_sample,
           lambda: sp.greedy_sample(meta((8, V), f32)),
           [((8,), torch.int32), ((8,), f32)], work.greedy_sample_work(8, V))
    yield ("topk_values", sp.topk_values,
           lambda: sp.topk_values(meta((8, V), f32), 50),
           [((8, 50), f32)], work.topk_work(8, V, 50))
    yield ("topk_mask", sp.topk_mask,
           lambda: sp.topk_mask(meta((8, V), f32), 50),
           [((8, V), f32)], work.topk_work(8, V, 50, with_mask=True))
    Hr, Dk = 64, 64
    yield ("rwkv6_scan", rs.rwkv6_scan,
           lambda: rs.rwkv6_scan(meta((1, 200, Hr, Dk)),
                                 meta((1, 200, Hr, Dk)),
                                 meta((1, 200, Hr, Dk)),
                                 meta((1, 200, Hr, Dk), f32),
                                 meta((Hr, Dk), f32)),
           [((1, 200, Hr, Dk), torch.bfloat16), ((1, Hr, Dk, Dk), f32)],
           work.rwkv6_scan_work(1, 200, Hr, Dk, Dk, "bfloat16"))
    Hm, N, hd = 80, 64, 64
    rk = meta((1, 200, 1, N)).expand(1, 200, Hm, N)
    yield ("mamba2_scan", ms.mamba2_scan,
           lambda: ms.mamba2_scan(rk, rk, meta((1, 200, Hm, hd), f32),
                                  meta((1, 200, Hm, 1), f32)),
           [((1, 200, Hm, hd), f32), ((1, Hm, N, hd), f32)],
           work.mamba2_scan_work(1, 200, Hm, N, hd, "bfloat16", "float32"))


@pytest.mark.parametrize("case", list(range(9)))
def test_kernel_meta_case_shapes_and_work(case):
    from repro_torch.launch.cost import walk
    name, wrapper, call, outs, (ops, n_bytes) = list(_kernel_cases())[case]
    before = wrapper.launches
    with walk() as costs:
        got = call()
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert all(t.device.type == "meta" for t in got)
    assert wrapper.launches == before            # nothing launched
    assert costs.kernel_launches == {name: 1}
    assert costs.kernel_ops == {name: ops}
    assert costs.kernel_bytes == {name: n_bytes}
    assert costs.flops == sum(ops.values()) and costs.product_flops == 0


def test_kernel_meta_case_validates_as_on_cuda():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sampling as sp
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(meta((1, 8, 2, 100)), meta((1, 8, 2, 100)),
                           meta((1, 8, 2, 100)))
    with pytest.raises(ValueError, match="H/Hkv"):
        da.decode_attention(meta((2, 18, 128)), meta((2, 64, 2, 128)),
                            meta((2, 64, 2, 128)), meta((2,), torch.int32))
    with pytest.raises(ValueError, match="float32"):
        sp.greedy_sample(meta((2, 100)))
    # and nothing is recorded outside a walk
    fa.flash_attention(meta((1, 8, 2, 64)), meta((1, 8, 2, 64)),
                       meta((1, 8, 2, 64)))


def _reference_and_port(B=4, S=64, MB=2):
    """The reduced internlm2's reference HLO walks and the port's cost
    walks of the train step and the prefill."""
    from repro.launch.hlo_cost import analyze_hlo
    from repro.models import build_model as ref_build
    from repro.rl.train_step import make_train_step as ref_step
    from repro.train.optimizer import AdamWConfig as RefAdamW
    from repro.train.optimizer import adamw_init as ref_adamw_init

    from repro_torch.launch.cost import analyze_step
    from repro_torch.models import build_model
    from repro_torch.rl.train_step import make_train_step
    from repro_torch.train.optimizer import adamw_init
    arch = "internlm2-1.8b"
    rm, pm = ref_build(arch, reduced=True), build_model(arch, reduced=True)
    sds = jax.ShapeDtypeStruct
    rp = rm.init_abstract()
    rstate = {"params": rp,
              "opt": jax.eval_shape(lambda p: ref_adamw_init(p), rp)}
    rbatch = {k: sds((B, S), jnp.int32 if k in ("tokens", "labels")
                     else jnp.float32)
              for k in ("tokens", "labels", "loss_mask", "advantages")}
    ref_train = analyze_hlo(jax.jit(ref_step(
        rm, RefAdamW(), microbatches=MB, remat=True)).lower(
        rstate, rbatch).compile().as_text())
    cache = jax.eval_shape(lambda: rm.init_cache(B, S))
    ref_prefill = analyze_hlo(jax.jit(
        lambda p, t, c: rm.prefill(p, t, c)).lower(
        rp, sds((B, S), jnp.int32), cache).compile().as_text())
    pp = pm.init_abstract()
    pbatch = {k: meta((B, S), torch.int32 if k in ("tokens", "labels")
                      else torch.float32)
              for k in ("tokens", "labels", "loss_mask", "advantages")}
    port_train = analyze_step(make_train_step(pm, microbatches=MB,
                                              remat=True),
                              {"params": pp, "opt": adamw_init(pp)}, pbatch)
    port_prefill = analyze_step(pm.prefill, pp, meta((B, S), torch.int32),
                                pm.init_cache(B, S, device="meta"))
    return pm.cfg, (B, S, MB), ref_train, ref_prefill, port_train, \
        port_prefill


@pytest.fixture(scope="module")
def walks():
    return _reference_and_port()


def test_train_step_products_match_the_reference_hlo_walk(walks):
    cfg, (B, S, MB), ref, _, port, _ = walks
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    square = B * H * S * S * D * L          # one full S x S product, all rows
    bwd = port.scoped_flops["flash_attention_backward"]
    assert ref.flops - 16 * square == port.product_flops - bwd
    assert bwd == 10 * square
    pairs = S * (S + 1) // 2
    assert port.kernel_launches == {"flash_attention": 2 * L * MB}
    assert port.kernel_flops == 2 * L * (2 * B * H * (D + D) * pairs)
    assert port.coll_ops == 0 and port.collective_bytes == 0
    assert port.peak_bytes > 0 and port.bytes > 0


def test_prefill_products_match_the_reference_hlo_walk(walks):
    cfg, (B, S, _), _, ref, _, port = walks
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    square = B * H * S * S * D * L
    assert ref.flops - 4 * square == port.product_flops
    assert port.kernel_launches == {"flash_attention": L}
    assert port.kernel_flops == L * 2 * B * H * 2 * D * S * (S + 1) // 2


def _fake_world_rank(rank, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import work
    from repro_torch.launch.cost import walk

    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                             "model"))

    def dt(shape, place, dtype=torch.bfloat16):
        return distribute_tensor(meta(shape, dtype), mesh, place,
                                 src_data_rank=None)
    M, K, N = 1024, 2048, 8192
    res = {"global": 2 * M * K * N}
    x = dt((M, K), [Shard(0), Replicate()])
    w = dt((K, N), [Replicate(), Shard(1)])
    with walk() as c:
        y = torch.mm(x, w)
    res["sharded"] = (c.product_flops, c.collective_bytes,
                      tuple(y.placements))
    xr = dt((M, K), [Replicate(), Replicate()])
    wr = dt((K, N), [Replicate(), Replicate()])
    with walk() as c:
        torch.mm(xr, wr)
    res["replicated"] = (c.product_flops, c.collective_bytes)
    with walk() as c:
        x.redistribute(mesh, [Replicate(), Replicate()])
    res["gather"] = (dict(c.coll), c.coll_ops, M * K * 2)
    B, S, H, Hkv, D = 32, 128, 16, 8, 64
    q = dt((B, S, H, D), [Shard(0), Shard(2)])
    k = dt((B, S, Hkv, D), [Shard(0), Replicate()])
    v = dt((B, S, Hkv, D), [Shard(0), Replicate()])
    with walk() as c:
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
    res["flash"] = (tuple(out.shape), tuple(out.placements),
                    tuple(out.to_local().shape), tuple(lse.placements),
                    c.kernel_ops, c.kernel_bytes,
                    work.flash_attention_work(B // 16, S, H // 16, Hkv, D,
                                              D))
    dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, "res.pt"))


def test_fake_world_counts_per_rank(tmp_path):
    import torch.multiprocessing as mp
    from torch.distributed.tensor import Replicate, Shard
    mp.start_processes(_fake_world_rank, args=(str(tmp_path),), nprocs=1,
                       start_method="spawn")
    res = torch.load(tmp_path / "res.pt", weights_only=False)
    flops, coll, place = res["sharded"]
    assert flops == res["global"] / 256 and coll == 0
    assert place == (Shard(0), Shard(1))
    assert res["replicated"] == (res["global"], 0)
    coll, n_ops, nbytes = res["gather"]
    assert n_ops == 1 and coll["all-gather"] == nbytes
    assert sum(coll.values()) == nbytes
    shape, place, local, lse_place, ops, nb, (want_ops, want_bytes) = \
        res["flash"]
    assert shape == (32, 128, 16, 64) and local == (2, 128, 1, 64)
    assert place == (Shard(0), Shard(2)) and lse_place == (Shard(0),
                                                           Shard(1))
    assert ops == {"flash_attention": want_ops}
    assert nb == {"flash_attention": want_bytes}
