"""Whole-name import checks: nothing a run imports is JAX or the JAX
package (``repro``; the port's ``repro_torch`` only begins with that
name), the reference imports nothing of the program, and no harness file
reads the JAX package's old benchmark outputs."""
import ast
import json
import subprocess
import sys

from rlbench import run as R

HERE = R.ROOT / "rlbench"


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_run_imports_no_jax_in_a_fresh_process():
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(R.ROOT)!r}, {str(R.ROOT / 'src')!r}]\n"
        "from rlbench import run as R\n"
        "from rlbench.harness import grpo, check, config, trace, work, weights\n"
        "from rlbench.reference import models, grpo as rg\n"
        "grpo.job_class(); grpo.recording_cache(1)\n"
        "from repro_torch.rl.coexec import run_coexec, run_sequential\n"
        "from repro_torch.core.phase_control import RollMuxRuntime\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.kernels import flash_attention\n"
        f"for m in {[m['name'] for m in bench['per_layer']]!r}:\n"
        "    R.reader(m)\n"
        "print(','.join(R.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_are_whole_names(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in R.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.probe", sys)
    assert R.forbidden_modules() == ["repro"]


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for mod in imports_of(path):
            top = mod.split(".")[0]
            assert top not in ("repro_torch", "repro", "jax"), (path, mod)


def test_harness_never_reads_the_old_benchmarks():
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path
        for mod in imports_of(path):
            assert mod.split(".")[0] not in ("jax", "repro", "benchmarks")
