"""The port stands alone: no JAX and nothing of the JAX package.

A static scan of every file under ``src/repro_torch/``, of
``chip_smoke.py``, the ported examples (``examples/*_torch.py``) and
``tools/check_port_invariants.py`` for imports of ``jax`` or ``repro``; a
subprocess that imports the whole port and finds no ``jax`` module loaded;
and the no-silent-CPU rule of the entry points.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py"))
             + [ROOT / "tools" / "check_port_invariants.py"])
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.cuda\n"
        "import repro_torch.analysis.verify_plan, repro_torch.analysis.widths\n"
        "import repro_torch.analysis.arena_sanitizer, repro_torch.perfmodel\n"
        "import repro_torch.configs, repro_torch.models.zoo\n"
        "import repro_torch.kernels.flash_attention, repro_torch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.launch.join_service, repro_torch.core.streaming\n"
        "import repro_torch.core.distributed\n"
        "import repro_torch.optim.compression, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.runtime\n"
        "import repro_torch.data.relations\n"
        "import repro_torch.analysis.lint_invariants\n"
        "import repro_torch.parallel, repro_torch.parallel.sharding\n"
        "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.launch.step_stats\n"
        "import repro_torch.models.moe, repro_torch.core.partition\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_need_the_card_unless_asked_for_cpu():
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.relation import Relation
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Relation.from_arrays(a=[1, 2, 3])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        relation_from_numpy({"a": [1, 2, 3]})
    rel = Relation.from_arrays(a=[1, 2, 3], device="cpu")
    assert rel.device == torch.device("cpu")
    # the join service's CLI defaults to the card too
    from repro_torch.launch import join_service
    with pytest.raises(RuntimeError, match='device="cpu"'):
        join_service.main(["--smoke", "--rows", "8"])


def test_baseline_entry_points_need_the_card_unless_asked_for_cpu():
    """The baselines take relations, which live on the card unless built
    with ``device="cpu"``; CPU relations keep every result on the CPU."""
    import numpy as np

    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import binary_join, linear3, reference
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default is the card")
    cols = {"b": np.arange(40, dtype=np.int32) % 7,
            "c": np.arange(40, dtype=np.int32) % 5}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        relation_from_numpy(cols)
    rel = relation_from_numpy(cols, device="cpu")
    plan = linear3.default_plan(40, 40, 40, m_budget=16, u=2)
    res, _ = reference.linear3_count_auto(rel, rel, rel, plan)
    count, _ = binary_join.bucketed_join_count(rel, "b", rel, "b", 4, 40, 40)
    assert res.count.device.type == count.device.type == "cpu"
