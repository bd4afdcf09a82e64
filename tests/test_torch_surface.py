"""The port's public surface is the JAX package's.

A static comparison of the two packages' sources (``ast``; nothing is
imported): for every module of ``src/repro/``, the module at the same
path under ``src/repro_torch/``, each public top-level name of it (a
function, class or constant; not a re-import), and each parameter of each
public function.  The differences by design are the tables below, each
with its reason and the port's counterpart; an entry that no longer
matches a difference fails too, so the tables cannot go stale.
"""

from __future__ import annotations

import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# A counterpart is None (the port has none), a port path ("kernels/ops.py"),
# a top-level name of a port module ("core/engine.py:traffic64"), or, for a
# parameter, a parameter of the port's function ("gen").

# modules of the JAX package with no file at the same path in the port
MODULES = {
    "compat.py": ("shims that keep older jax versions running; the port "
                  "calls torch's own API", None),
    "kernels/bucket_join.py": ("the join kernels' Pallas sources; their "
                               "Hopper counterparts are kernels/csrc/*.cu, "
                               "built and bound here", "kernels/cuda.py"),
    "kernels/radix_hist.py": ("the radix histogram's Pallas source; its "
                              "counterpart is kernels/csrc/radix_hist.cu, "
                              "built and bound here", "kernels/cuda.py"),
    "kernels/ref.py": ("the kernels' plain versions are the CPU half of the "
                       "port's dispatching ops", "kernels/ops.py"),
    "launch/hlo_stats.py": ("reads XLA's compiled HLO; the port records the "
                            "step's torch ops", "launch/step_stats.py"),
}

# public top-level names the port's module at the same path lacks
NAMES = {
    ("core/engine.py", "Traffic64"): (
        "int32 limbs of a 64-bit count; torch has int64",
        "core/engine.py:traffic64"),
    ("launch/hlo_analysis.py", "ICI_BW"): (
        "the TPU's inter-chip link rate; the port holds the H100's",
        "launch/hlo_analysis.py:NVLINK_BW"),
    ("launch/hlo_analysis.py", "parse_collectives"): (
        "parses HLO text; the port counts c10d ops as the step runs",
        "launch/step_stats.py:StepStats"),
    ("launch/train.py", "OVERLAP_FLAGS"): (
        "XLA flags for overlapping collectives; no meaning in torch", None),
}

# parameters the port leaves out wherever the JAX package's function has
# them
PARAMS = {
    "use_kernel": ("the device chooses: a CUDA tensor launches the Hopper "
                   "kernel, a CPU tensor takes the plain version", None),
    "key": ("random draws come from a torch.Generator", "gen"),
    "interpret": ("Pallas interpret mode; the plain version is the CPU "
                  "path", None),
    "q_chunk": ("Pallas tiling of q; the CUDA kernels choose their tiles",
                None),
    "kv_chunk": ("Pallas tiling of k/v; the CUDA kernels choose their "
                 "tiles", None),
    "logical": ("a weight's sharding axes, unused by the JAX package's "
                "inits too; the port places weights by their specs",
                "launch/specs.py:param_specs"),
}

# one function's parameter that the port names otherwise
RENAMED = {
    ("models/layers.py", "embed", "table"): (
        "the Embed module, which knows its vocabulary's split under "
        "tensor parallelism", "p"),
    ("models/layers.py", "unembed", "table"): (
        "the Embed module, as in embed", "p"),
    ("launch/specs.py", "param_shardings", "params_abs"): (
        "no abstract pytrees: placements read the tensors (meta tensors "
        "for shapes)", "params"),
    ("launch/specs.py", "state_shardings", "state_abs"): (
        "as param_shardings", "state"),
    ("launch/specs.py", "batch_shardings", "batch_abs"): (
        "as param_shardings", "batch"),
    ("launch/specs.py", "cache_shardings", "cache_abs"): (
        "as param_shardings", "cache"),
    ("launch/specs.py", "abstract_state", "cell"): (
        "the state on the meta device from the model, where the JAX "
        "package evaluates a cell's shapes", "model"),
}


def _bindings(body):
    """Top-level statements, into the bodies of ``if`` / ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _bindings(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _bindings(node.body + node.orelse + node.finalbody
                                 + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _params(fn):
    a = fn.args
    return {"named": [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs],
            "star": a.vararg is not None, "kw": a.kwarg is not None}


@functools.lru_cache(maxsize=None)
def surface(path: pathlib.Path):
    """(defined, imported): the public names a module defines at its top
    level ({name: parameters, or None for a class or constant}) and the
    names it imports."""
    defined, imported = {}, set()
    for node in _bindings(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            defined[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                defined.update({e.id: None for e in elts
                                if isinstance(e, ast.Name)})
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0]
                            for a in node.names)
    return ({k: v for k, v in defined.items() if not k.startswith("_")},
            imported)


def ref_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _port_has(module: str, name: str) -> bool:
    defined, imported = surface(PORT / module)
    return name in defined or name in imported


def differences(module: str) -> list:
    """Every way the port's module at ``module`` falls short of the JAX
    package's: ("module",), ("name", name) or ("param", function,
    parameter)."""
    if not (PORT / module).exists():
        return [("module",)]
    ref, _ = surface(REF / module)
    port, _ = surface(PORT / module)
    out = []
    for name, params in ref.items():
        if not _port_has(module, name):
            out.append(("name", name))
        elif params is not None and port.get(name) is not None:
            got = port[name]
            out += [("param", name, p) for p in params["named"]
                    if p not in got["named"]]
            if params["star"] and not got["star"]:
                out.append(("param", name, "*"))
            if params["kw"] and not got["kw"]:
                out.append(("param", name, "**"))
    return out


def departure(module: str, diff: tuple):
    """The table entry that explains ``diff``, or None."""
    if diff[0] == "module":
        return MODULES.get(module)
    if diff[0] == "name":
        return NAMES.get((module, diff[1]))
    return (RENAMED.get((module, diff[1], diff[2]))
            or PARAMS.get(diff[2]))


def _counterpart_ok(counterpart, module=None, function=None) -> bool:
    if counterpart is None:
        return True
    path, _, name = counterpart.partition(":")
    if path.endswith(".py"):
        return (PORT / path).exists() and (not name or _port_has(path, name))
    port, _ = surface(PORT / module)
    return port.get(function) is not None and \
        counterpart in port[function]["named"]


def test_scan_reads_both_packages():
    mods = ref_modules()
    assert len(mods) > 60 and "core/session.py" in mods
    defined, _ = surface(PORT / "core/session.py")
    assert "JoinSession" in defined
    assert "positions" in surface(PORT / "models/attention.py")[0][
        "cross_attention"]["named"]


@pytest.mark.parametrize("module", ref_modules())
def test_module_surface_matches_reference(module):
    unexplained = [d for d in differences(module)
                   if departure(module, d) is None]
    assert not unexplained, (
        f"{module}: the port lacks {unexplained}; port it, or add the "
        "difference to a table of this file with its reason")


def _all_differences():
    return [(m, d) for m in ref_modules() for d in differences(m)]


@pytest.mark.parametrize("module, diff", _all_differences(), ids=[
    ":".join((m,) + d[1:]) for m, d in _all_differences()])
def test_each_departure_names_its_counterpart(module, diff):
    reason, counterpart = departure(module, diff) or ("", None)
    assert reason, (module, diff)
    fn = diff[1] if diff[0] == "param" else None
    assert _counterpart_ok(counterpart, module, fn), (module, diff,
                                                      counterpart)


def _entries():
    return ([("module", k) for k in MODULES] + [("name", k) for k in NAMES]
            + [("param", k) for k in PARAMS]
            + [("renamed", k) for k in RENAMED])


@pytest.mark.parametrize("table, key", _entries(),
                         ids=[f"{t}-{k}" for t, k in _entries()])
def test_departure_table_entry_is_still_a_difference(table, key):
    """An entry that no longer matches a difference fails: the port
    gained the name (drop the entry) or the reference lost it."""
    if table == "module":
        assert (REF / key).exists() and key in ref_modules()
        assert ("module",) in differences(key)
    elif table == "name":
        assert ("name", key[1]) in differences(key[0])
    elif table == "param":
        hits = [(m, d) for m, d in _all_differences()
                if d[0] == "param" and d[2] == key
                and (m, d[1], d[2]) not in RENAMED]
        assert hits, f"no function of the port lacks {key!r} any more"
    else:
        module, function, param = key
        assert ("param", function, param) in differences(module)
