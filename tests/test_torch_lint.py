"""The port's invariant lint (``repro_torch.analysis.lint_invariants``) and
its gate (``tools/check_port_invariants.py``): clean on the port's tree,
and each rule fires on a planted file and not on its allowed form.
"""

import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis import lint_invariants

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "check_port_invariants.py"


def _rules(findings):
    return [f.split("[")[1].split("]")[0] for f in findings]


def _lint(tmp_path, text, name="planted.py"):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return _rules(lint_invariants.lint_file(path))


def test_lint_clean_on_the_port():
    paths = [ROOT / "src" / "repro_torch", ROOT / "chip_smoke.py", TOOL,
             *sorted((ROOT / "examples").glob("*_torch.py"))]
    assert len(paths) >= 8
    assert lint_invariants.lint_paths(paths) == []


def test_carried_rules_fire_on_the_reference_plants(tmp_path):
    """The reference lint's planted file (tests/test_analysis.py), same
    counts per rule."""
    rules = _lint(tmp_path,
                  "import numpy as np\n"
                  "def f(rel, x):\n"
                  "    rel.columns['a'] = x\n"
                  "    rel.valid = x\n"
                  "    object.__setattr__(rel, 'columns', {})\n"
                  "    u = np.unique(x)\n"
                  "    s = -0x7FFFFFFF\n"
                  "    tot = np.sum(x, dtype=np.float32)\n"
                  "    tot2 = x.astype(np.float32).sum()\n"
                  "    return u, s, tot, tot2\n")
    assert rules.count("relation-mutation") == 3
    assert rules.count("np-unique") == 1
    assert rules.count("sentinel-literal") == 1
    assert rules.count("float-count-accum") == 2
    assert len(rules) == 7


def test_float_count_accum_fires_on_torch_spellings(tmp_path):
    rules = _lint(tmp_path,
                  "import torch\n"
                  "def f(x, w):\n"
                  "    a = torch.sum(x, dtype=torch.float32)\n"
                  "    b = torch.cumsum(x, 0, dtype=torch.float64)\n"
                  "    c = x.bincount(dtype=torch.double)\n"
                  "    d = x.float().sum()\n"
                  "    e = x.double().sum()\n"
                  "    f = x.to(torch.float32).sum()\n"
                  "    g = x.to(dtype=torch.bfloat16).sum(0)\n"
                  "    h = x.type(torch.float16).sum()\n"
                  "    i = x.half().sum()\n"
                  "    return a, b, c, d, e, f, g, h, i\n")
    assert rules == ["float-count-accum"] * 9


def test_float_count_accum_allows_float_products(tmp_path):
    """An f32 row sum of a product (the attention backward's ``o·do``),
    integer sums and casts that feed no sum are not counts in floats."""
    rules = _lint(tmp_path,
                  "import torch\n"
                  "def f(o, do, x):\n"
                  "    delta = (o.float() * do.float()).sum(-1)\n"
                  "    n = x.to(torch.int64).sum()\n"
                  "    m = torch.sum(x, dtype=torch.int64)\n"
                  "    y = x.float()\n"
                  "    z = x.to(o.device).sum()\n"
                  "    return delta, n, m, y, z\n")
    assert rules == []


def test_carried_rules_allow_their_implementation_files(tmp_path):
    core = tmp_path / "core"
    assert _lint(core, "def f(rel, x):\n"
                       "    rel.columns['a'] = x\n"
                       "    object.__setattr__(rel, '_version', 2)\n"
                       "    s = -0x7FFFFFFF\n"
                       "    return s\n", "relation.py") == []
    assert _lint(core, "import numpy as np\n"
                       "def g(x):\n"
                       "    return np.unique(x)\n", "reference.py") == []


@pytest.mark.parametrize("text,count", [
    ("import jax\n", 1),
    ("import jax.numpy as jnp\n", 1),
    ("from jax import lax\n", 1),
    ("import jaxlib\n", 1),
    ("import repro\n", 1),
    ("from repro.core import sketches\n", 1),
    ("from repro.kernels.ops import fm_registers\n", 1),
    ("import importlib\nm = importlib.import_module('jax.numpy')\n", 1),
    ("m = __import__('repro')\n", 1),
])
def test_reference_import_fires(tmp_path, text, count):
    assert _lint(tmp_path, text) == ["reference-import"] * count


def test_reference_import_allows_the_port(tmp_path):
    assert _lint(tmp_path,
                 "import repro_torch\n"
                 "from repro_torch.core import sketches\n"
                 "import importlib\n"
                 "m = importlib.import_module('repro_torch.kernels.cuda')\n"
                 "from . import jax_free\n") == []


def test_use_kernel_flag_fires(tmp_path):
    rules = _lint(tmp_path,
                  "def op(x, *, use_kernel=False):\n"
                  "    return x\n"
                  "def op2(x, use_kernel):\n"
                  "    return op(x, use_kernel=use_kernel)\n")
    assert rules == ["use-kernel-flag"] * 3


def test_use_kernel_flag_allows_other_names(tmp_path):
    assert _lint(tmp_path,
                 "def op(x, *, kernel=None, use_cache=False):\n"
                 "    use_kernel_launches = 3\n"
                 "    return op(x, kernel=kernel)\n") == []


def test_cpu_default_fires(tmp_path):
    rules = _lint(tmp_path,
                  "import argparse\n"
                  "import torch\n"
                  "def a(x, device='cpu'):\n"
                  "    return x\n"
                  "def b(x, *, device=torch.device('cpu')):\n"
                  "    return x\n"
                  "f = lambda device='cpu': device\n"
                  "ap = argparse.ArgumentParser()\n"
                  "ap.add_argument('--device', default='cpu')\n")
    assert rules == ["cpu-default"] * 4


def test_cpu_default_allows_the_card_and_explicit_cpu(tmp_path):
    assert _lint(tmp_path,
                 "import argparse\n"
                 "import torch\n"
                 "def a(x, device=None):\n"
                 "    return x.to(device)\n"
                 "def b(x, *, device='cuda'):\n"
                 "    return a(x, device='cpu')\n"
                 "def c(x, where='cpu'):\n"
                 "    return torch.device('cpu')\n"
                 "ap = argparse.ArgumentParser()\n"
                 "ap.add_argument('--device', default=None)\n"
                 "ap.add_argument('--where', default='cpu')\n") == []


def test_kernel_fallback_fires(tmp_path):
    rules = _lint(tmp_path,
                  "from repro_torch.kernels import cuda\n"
                  "import repro_torch.kernels.cuda as kc\n"
                  "def f(x, plain):\n"
                  "    try:\n"
                  "        return cuda.fused_count3_linear(x)\n"
                  "    except RuntimeError:\n"
                  "        return plain(x)\n"
                  "def g(x, plain):\n"
                  "    try:\n"
                  "        kc.build()\n"
                  "    except Exception:\n"
                  "        pass\n"
                  "    try:\n"
                  "        y = cuda.radix_histogram(x)\n"
                  "    except ValueError:\n"
                  "        raise\n"
                  "    except OSError:\n"
                  "        y = plain(x)\n"
                  "    return y\n")
    assert rules == ["kernel-fallback"] * 3


def test_kernel_fallback_allows_raising_and_other_calls(tmp_path):
    assert _lint(tmp_path,
                 "import torch\n"
                 "from repro_torch.kernels import cuda\n"
                 "def f(x):\n"
                 "    try:\n"
                 "        return cuda.bucket_pair_count(x)\n"
                 "    except OSError as exc:\n"
                 "        raise RuntimeError('build failed') from exc\n"
                 "def g(x):\n"
                 "    try:\n"
                 "        torch.cuda.synchronize()\n"
                 "    except RuntimeError:\n"
                 "        return None\n"
                 "    try:\n"
                 "        from repro_torch.kernels import cuda as c2\n"
                 "    except ImportError:\n"
                 "        return None\n"
                 "    return x\n") == []


def test_gate_exits_zero_on_the_repo():
    out = subprocess.run([sys.executable, str(TOOL)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


def test_gate_exits_nonzero_on_a_planted_file(tmp_path):
    bad = tmp_path / "bad_torch.py"
    bad.write_text("import jax\n"
                   "def f(x, device='cpu', use_kernel=True):\n"
                   "    return x.float().sum()\n")
    out = subprocess.run([sys.executable, str(TOOL), str(bad)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    for rule in ("reference-import", "cpu-default", "use-kernel-flag",
                 "float-count-accum"):
        assert f"[{rule}]" in out.stdout
