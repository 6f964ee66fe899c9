"""The port stands alone and never hides the card or a kernel.

* No file of ``src/repro_torch`` (nor ``chip_smoke.py`` and
  ``profile_step.py``) imports ``jax`` or the JAX package ``repro``.
* No module defines a top-level function or class twice (ruff's F811,
  held here too so that the test suite catches it without ruff).
* Entry points called without ``device`` on a machine with no CUDA card
  raise instead of running on the CPU.
* A kernel wrapper handed CUDA tensors with no CUDA toolchain present
  raises; it never returns its plain version's result.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_step.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def _defined_twice(source: str) -> list:
    """Top-level function and class names defined more than once."""
    seen, twice = set(), []
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name in seen:
                twice.append(f"{node.name} (line {node.lineno})")
            seen.add(node.name)
    return twice


def test_no_top_level_name_defined_twice():
    assert _defined_twice("def f():\n    pass\n\n\ndef g():\n    pass\n"
                          "\n\ndef f():\n    pass\n") == ["f (line 9)"]
    found = {str(p.relative_to(ROOT)): _defined_twice(p.read_text())
             for p in PORT_FILES}
    assert not {p: d for p, d in found.items() if d}


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device default is valid")


def test_entry_points_without_device_raise_on_a_cpu_only_machine():
    _no_cuda()
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.launch.train import run_training
    from repro_torch.models import build_model
    from repro_torch.rl.coexec import GRPOJob
    from repro_torch.serve import Engine, EngineConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_continuous("internlm2-1.8b", [[1, 2, 3]], reduced=True,
                         max_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(reduced=True, steps=1, batch=1, group=2, max_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRPOJob("job0", reduced=True)
    m = build_model("internlm2-1.8b", reduced=True)
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, params, EngineConfig(num_slots=1, max_seq_len=8))


def _cuda_calls():
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.sampling import (greedy_sample, topk_mask,
                                              topk_values)
    i32 = dict(dtype=torch.int32, device="cuda")
    bf = dict(dtype=torch.bfloat16, device="cuda")
    q = torch.zeros(2, 4, 16, **bf)
    kv = torch.zeros(2, 8, 2, 16, **bf)
    pool = torch.zeros(5, 4, 2, 16, **bf)
    tables = torch.zeros(2, 2, **i32)
    lengths = torch.ones(2, **i32)
    return {
        "decode_attention": lambda: decode_attention(q, kv, kv, lengths),
        "paged_decode_attention": lambda: paged_decode_attention(
            q, pool, pool, tables, lengths),
        "greedy_sample": lambda: greedy_sample(
            torch.zeros(2, 100, dtype=torch.float32, device="cuda")),
        "flash_attention": lambda: flash_attention(
            torch.zeros(2, 8, 4, 16, **bf), kv, kv),
        "rwkv6_scan": lambda: rwkv6_scan(
            kv, kv, kv, kv.float(),
            torch.zeros(2, 16, dtype=torch.float32, device="cuda")),
        "mamba2_scan": lambda: mamba2_scan(
            kv, kv, kv.float(),
            torch.zeros(2, 8, 2, 1, dtype=torch.float32, device="cuda")),
        "topk_values": lambda: topk_values(
            torch.zeros(2, 100, dtype=torch.float32, device="cuda"), 5),
        "topk_mask": lambda: topk_mask(
            torch.zeros(2, 100, dtype=torch.float32, device="cuda"), 5),
    }


@pytest.mark.parametrize("name", ["decode_attention",
                                  "paged_decode_attention", "greedy_sample",
                                  "flash_attention", "rwkv6_scan",
                                  "mamba2_scan", "topk_values",
                                  "topk_mask"])
def test_wrapper_on_cuda_tensors_raises_without_cuda(name, monkeypatch):
    """Fake CUDA tensors (no storage) reach the kernel path, which must
    raise for want of a toolchain, not answer with the plain version."""
    _no_cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-cuda-here"))
    monkeypatch.setenv("PATH", "")
    with FakeTensorMode():
        call = _cuda_calls()[name]
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
