"""repro_torch and chip_smoke.py stand alone: no file imports jax or the
JAX package (checked on the source, then on a fresh interpreter's
sys.modules after importing every port module)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports_in_source(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither():
    mods = [
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        for p in PORT.rglob("*.py")
    ]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_every_slice_module_is_checked():
    """The source check above walks the whole package: the attention
    slice's modules are among the files it reads."""
    checked = {str(p.relative_to(REPO)) for p in FILES}
    assert {
        "src/repro_torch/kernels/attention.py",
        "src/repro_torch/core/pipeline.py",
        "src/repro_torch/kernels/spmm.py",
        "src/repro_torch/kernels/sddmm.py",
        "src/repro_torch/core/autodiff.py",
        "src/repro_torch/train_gnn.py",
        "src/repro_torch/kernels/ops.py",
        "src/repro_torch/kernels/softmax.py",
        "src/repro_torch/core/batch.py",
        "src/repro_torch/core/resilience.py",
        "src/repro_torch/core/transfer.py",
        "src/repro_torch/shared_worker.py",
        "src/repro_torch/launch/serve.py",
        "src/repro_torch/obs_cli.py",
        "src/repro_torch/configs/__init__.py",
        "src/repro_torch/configs/base.py",
        "src/repro_torch/configs/qwen3_14b.py",
        "src/repro_torch/models/modules.py",
        "src/repro_torch/models/attention.py",
        "src/repro_torch/models/moe.py",
        "src/repro_torch/models/ssm.py",
        "src/repro_torch/models/rglru.py",
        "src/repro_torch/models/transformer.py",
        "src/repro_torch/models/encdec.py",
        "src/repro_torch/models/api.py",
        "src/repro_torch/train/step.py",
        "src/repro_torch/distributed/collectives.py",
        "src/repro_torch/distributed/sharding.py",
        "src/repro_torch/launch/mesh.py",
        "src/repro_torch/launch/train.py",
        "src/repro_torch/optim/compress.py",
        "src/repro_torch/checkpoint/ckpt.py",
        "chip_smoke.py",
    } <= checked
    archs = {f.stem for f in (PORT / "configs").glob("*.py")} - {"__init__", "base", "layers"}
    # every architecture, gnn_sage too, and the port-only mellum2 (its
    # per-layer attention plan in configs/layers.py)
    assert len(archs) == 12 and "mellum2" in archs
    serve = (PORT / "launch" / "serve.py").read_text()
    assert '"demo-lm"' in serve and "def demo_lm_main" in serve
    assert (PORT / "csrc" / "attention.cu").is_file()
    assert (PORT / "csrc" / "sddmm.cu").is_file()
    assert (PORT / "csrc" / "softmax.cu").is_file()


def _imported(node) -> set:
    """Dotted names an import statement names, its modules and their
    members."""
    if isinstance(node, ast.Import):
        return {a.name for a in node.names}
    return {node.module or ""} | {f"{node.module}.{a.name}" for a in node.names}


def test_pipeline_does_not_import_the_scheduler():
    """The decide layer's arrows point one way: core/scheduler.py imports
    core/pipeline.py, and pipeline.py imports nothing of the scheduler,
    at its top or inside a function; no function of the scheduler
    imports the pipeline lazily."""
    def tree(name):
        return ast.parse((PORT / "core" / f"{name}.py").read_text())

    pipe = set().union(*(_imported(n) for n in ast.walk(tree("pipeline"))
                         if isinstance(n, (ast.Import, ast.ImportFrom))))
    assert pipe and not any(m.split(".")[-1] == "scheduler" for m in pipe)
    sched = tree("scheduler")
    top = set().union(*(_imported(n) for n in sched.body
                        if isinstance(n, (ast.Import, ast.ImportFrom))))
    assert "repro_torch.core.pipeline" in top
    lazy = [n for f in ast.walk(sched) if isinstance(f, ast.FunctionDef)
            for n in ast.walk(f) if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("pipeline" in m for n in lazy for m in _imported(n))
