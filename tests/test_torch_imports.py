"""Import boundary of the port: no module of sldm_gnn_tpu_torch and not
chip_smoke.py may import JAX, flax, pandas, click or the JAX package (the
card's machine has none of them). Checked on the source (AST), since the
test process itself has JAX loaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pandas", "click", "sldm_gnn_tpu"}
PORT_FILES = sorted((ROOT / "sldm_gnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            roots |= {a.value.split(".")[0] for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return roots


TRAINING_SLICE = ["sldm_gnn_tpu_torch/train/loop.py", "sldm_gnn_tpu_torch/train/losses.py",
                  "sldm_gnn_tpu_torch/train/snapshot.py", "sldm_gnn_tpu_torch/evals/metrics.py",
                  "sldm_gnn_tpu_torch/models/map_modules.py"]


BANDED_SLICE = ["sldm_gnn_tpu_torch/graph/csr.py", "sldm_gnn_tpu_torch/ops/spmm_banded.py",
                "sldm_gnn_tpu_torch/ops/sage_fused.py", "sldm_gnn_tpu_torch/ops/banded_residual.py",
                "sldm_gnn_tpu_torch/models/blocked_sage.py", "sldm_gnn_tpu_torch/interop.py"]


LAYOUT_SLICE = ["sldm_gnn_tpu_torch/ops/spmm.py", "sldm_gnn_tpu_torch/ops/spmm_dense.py",
                "sldm_gnn_tpu_torch/ops/spmm_hybrid.py", "sldm_gnn_tpu_torch/ops/spmm_gather.py",
                "sldm_gnn_tpu_torch/ops/quant.py"]


INT8_SDDMM_SLICE = ["sldm_gnn_tpu_torch/ops/sddmm.py", "sldm_gnn_tpu_torch/graph/reorder.py",
                    "sldm_gnn_tpu_torch/graph/layout_io.py"]


LAST_KERNELS_SLICE = ["sldm_gnn_tpu_torch/ops/spmm_mk.py", "sldm_gnn_tpu_torch/ops/spmm_cmap.py",
                      "sldm_gnn_tpu_torch/models/attention.py",
                      "sldm_gnn_tpu_torch/ops/gru_cuda.py"]


PARALLEL_SLICE = ["sldm_gnn_tpu_torch/parallel/__init__.py",
                  "sldm_gnn_tpu_torch/parallel/halo.py",
                  "sldm_gnn_tpu_torch/parallel/halo_fused.py",
                  "sldm_gnn_tpu_torch/parallel/halo_model.py"]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "sldm_gnn_tpu_torch/ops/gru_cuda.py" in names
    assert "chip_smoke.py" in names
    assert set(TRAINING_SLICE) <= names  # the scan covers the training slice
    assert set(BANDED_SLICE) <= names  # and the banded GraphSAGE slice
    assert set(LAYOUT_SLICE) <= names  # and the one-hot, dense, hybrid and gather layouts
    assert set(INT8_SDDMM_SLICE) <= names  # and the int8 one-hot, SDDMM, reorder, layout files
    assert set(LAST_KERNELS_SLICE) <= names  # and the megakernel, cmap, attention, v1 scan
    assert set(PARALLEL_SLICE) <= names  # and the halo planners and per-shard fused layers


def test_port_modules_import_with_jax_unavailable():
    """Every module of the port imports in a fresh interpreter in which
    importing jax, flax or the JAX package fails (transitive imports
    included)."""
    mods = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
            for p in PORT_FILES if p.parent != ROOT]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys\n"
            f"for name in {sorted(FORBIDDEN)!r}: sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_side_module(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_chip_smoke_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
