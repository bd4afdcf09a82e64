"""AST lint enforcing the port's exactness and dispatch invariants.

The JAX package's lint (``repro.analysis.lint_invariants``) checks the
conventions the engine's correctness argument leans on.  Four of its five
rules carry over to the port unchanged in meaning:

=================  =====================================================
rule               fires on
=================  =====================================================
relation-mutation  ``object.__setattr__(x, <field>, ...)`` for a
                   ``Relation`` field (columns/valid/_version/
                   _sketch_cache) outside ``core/relation.py``, or any
                   ``.columns``/``.valid`` attribute or ``.columns[...]``
                   subscript store
np-unique          ``np.unique``/``numpy.unique`` calls outside
                   ``core/reference.py`` (host oracles live there)
sentinel-literal   a literal ``-0x7FFFFFFF`` outside ``core/relation.py``
                   — spell it ``relation.SENTINEL``
float-count-accum  ``sum``/``cumsum``/``bincount`` with a float ``dtype``
                   kwarg (numpy's and torch's spellings), or a float cast
                   directly feeding ``.sum()``: ``.astype(<float>)``,
                   ``.float()``, ``.double()``, ``.half()``,
                   ``.to(<float>)`` or ``.type(<float>)`` — counts must
                   accumulate in int32/int64
=================  =====================================================

The fifth, ``pallas-gate`` (a ``pallas_call`` must thread the interpret
gate), has no meaning in the port: it has no Pallas kernel and no
interpret mode.  What replaces it are the port's own dispatch rules — a
CUDA tensor launches the hand-written kernel, a CPU tensor takes the plain
version, nothing falls back, and the port never runs the reference:

=================  =====================================================
reference-import   an import of ``jax``, ``jaxlib`` or ``repro`` (the
                   reference package), by statement or by
                   ``importlib.import_module`` / ``__import__`` of a
                   literal name
use-kernel-flag    a parameter or call keyword named ``use_kernel``: the
                   device picks the path, no flag may send a CUDA tensor
                   to the plain version
cpu-default        a parameter named ``device`` whose default is ``"cpu"``
                   or ``torch.device("cpu")``, or an ``add_argument(
                   "--device", default="cpu")``: entry points run on the
                   card unless the caller asks for the CPU
kernel-fallback    a ``try`` whose body calls into ``kernels.cuda`` and
                   one of whose ``except`` handlers does not raise: a
                   kernel that fails to build or launch must raise
=================  =====================================================

A float product summed along a row (``(o.float() * do.float()).sum(-1)``
in the attention backward) is no count and is not flagged: only a cast
that feeds ``.sum()`` directly is.

Run via ``python tools/check_port_invariants.py`` (the port's sources,
``chip_smoke.py``, the ported examples and the tool itself) or
``python -m repro_torch.analysis.lint_invariants [paths...]``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

_RELATION_FIELDS = frozenset(
    {"columns", "valid", "_version", "_sketch_cache"})
_SENTINEL_MAGNITUDE = 0x7FFFFFFF
_FLOAT_NAMES = ("float", "float16", "float32", "float64", "bfloat16",
                "double", "half")
_FLOAT_CASTS = ("float", "double", "half")
_REFERENCE_MODULES = frozenset({"jax", "jaxlib", "repro"})
_CUDA_MODULE = "repro_torch.kernels.cuda"

# rule -> path suffixes (posix) where the construct is the implementation
_ALLOWED = {
    "relation-mutation": ("core/relation.py",),
    "np-unique": ("core/reference.py",),
    "sentinel-literal": ("core/relation.py",),
}


def _attr_chain(node) -> str:
    """Dotted-name text of a Name/Attribute chain, '' if not one."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_float_dtype(node) -> bool:
    chain = _attr_chain(node)
    if chain:
        return chain.split(".")[-1] in _FLOAT_NAMES
    return isinstance(node, ast.Constant) and node.value in (float,)


def _is_float_cast(node) -> bool:
    """``x.astype(<float>)``, ``x.float()``, ``x.to(<float>)`` and kin."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    name = node.func.attr
    if name in _FLOAT_CASTS:
        return not node.args and not node.keywords
    if name in ("astype", "to", "type"):
        dtypes = list(node.args) + [kw.value for kw in node.keywords
                                    if kw.arg == "dtype"]
        return any(_is_float_dtype(a) for a in dtypes)
    return False


def _is_cpu(node) -> bool:
    """The literal ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and _attr_chain(node.func).split(".")[-1] == "device"
            and len(node.args) == 1 and _is_cpu(node.args[0]))


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.findings: list[tuple[int, str, str]] = []
        self._cuda_names = {"kernels.cuda", _CUDA_MODULE}

    def _emit(self, node, rule: str, message: str) -> None:
        if any(self.rel_path.endswith(sfx)
               for sfx in _ALLOWED.get(rule, ())):
            return
        self.findings.append((node.lineno, rule, message))

    # -- relation-mutation ---------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_store(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store(node.target)
        self.generic_visit(node)

    def _check_store(self, tgt) -> None:
        if isinstance(tgt, ast.Attribute) and tgt.attr in ("columns",
                                                           "valid"):
            self._emit(tgt, "relation-mutation",
                       f"direct store to .{tgt.attr} — Relation mutates "
                       "only through append()")
        if (isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Attribute)
                and tgt.value.attr == "columns"):
            self._emit(tgt, "relation-mutation",
                       "store into .columns[...] — Relation columns are "
                       "immutable; build a new Relation or use append()")

    # -- reference-import ----------------------------------------------

    def _check_module(self, node, name: str) -> None:
        if name.split(".")[0] in _REFERENCE_MODULES:
            self._emit(node, "reference-import",
                       f"import of {name!r} — the port runs without JAX "
                       "and keeps its own copy of what it needs from the "
                       "reference package")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_module(node, alias.name)
            if alias.name == _CUDA_MODULE and alias.asname:
                self._cuda_names.add(alias.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level == 0 and node.module:
            self._check_module(node, node.module)
            for alias in node.names:
                if f"{node.module}.{alias.name}" == _CUDA_MODULE:
                    self._cuda_names.add(alias.asname or alias.name)
        self.generic_visit(node)

    # -- use-kernel-flag, cpu-default: parameters ----------------------

    def _check_params(self, node) -> None:
        a = node.args
        positional = a.posonlyargs + a.args
        pairs = list(zip(positional[len(positional) - len(a.defaults):],
                         a.defaults))
        pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg in positional + a.kwonlyargs:
            if arg.arg == "use_kernel":
                self._emit(arg, "use-kernel-flag",
                           "parameter use_kernel — the device picks the "
                           "kernel or the plain version; no flag may")
        for arg, default in pairs:
            if arg.arg == "device" and _is_cpu(default):
                self._emit(arg, "cpu-default",
                           "device defaults to the CPU — entry points run "
                           "on the card unless the caller asks for the CPU")

    def visit_FunctionDef(self, node) -> None:
        self._check_params(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    # -- kernel-fallback -----------------------------------------------

    def _calls_cuda(self, nodes) -> bool:
        for stmt in nodes:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    chain = _attr_chain(n.func)
                    if any(chain.startswith(name + ".")
                           for name in self._cuda_names):
                        return True
        return False

    def visit_Try(self, node: ast.Try) -> None:
        if self._calls_cuda(node.body):
            for handler in node.handlers:
                if not any(isinstance(n, ast.Raise)
                           for n in ast.walk(handler)):
                    self._emit(handler, "kernel-fallback",
                               "except without raise around a call into "
                               "kernels.cuda — a kernel that fails to "
                               "build or launch must raise, not fall back")
        self.generic_visit(node)

    visit_TryStar = visit_Try

    # -- calls ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)

        if chain == "object.__setattr__" and len(node.args) >= 2:
            field = node.args[1]
            if (isinstance(field, ast.Constant)
                    and field.value in _RELATION_FIELDS):
                self._emit(node, "relation-mutation",
                           f"object.__setattr__(..., {field.value!r}, ...)"
                           " — Relation internals mutate only inside "
                           "core/relation.py")

        if chain.endswith(".unique") and chain.split(".")[0] in ("np",
                                                                 "numpy"):
            self._emit(node, "np-unique",
                       "host np.unique outside core/reference.py — the "
                       "device pipelines must not fall back to host "
                       "dedup; oracles belong in reference.py")

        if (chain.split(".")[-1] in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            self._check_module(node, node.args[0].value)

        for kw in node.keywords:
            if kw.arg == "use_kernel":
                self._emit(node, "use-kernel-flag",
                           "use_kernel= keyword — the device picks the "
                           "kernel or the plain version; no flag may")

        if (chain.split(".")[-1] == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--device"
                and any(kw.arg == "default" and _is_cpu(kw.value)
                        for kw in node.keywords)):
            self._emit(node, "cpu-default",
                       "--device defaults to the CPU — entry points run "
                       "on the card unless the caller asks for the CPU")

        # the called name even when the receiver is itself a call
        # (``x.float().sum()`` has no Name-rooted chain)
        if isinstance(node.func, ast.Attribute):
            func_name = node.func.attr
        elif isinstance(node.func, ast.Name):
            func_name = node.func.id
        else:
            func_name = ""
        if func_name in ("sum", "cumsum", "bincount"):
            for kw in node.keywords:
                if kw.arg == "dtype" and _is_float_dtype(kw.value):
                    self._emit(node, "float-count-accum",
                               f"{func_name}(dtype=<float>) — count "
                               "totals accumulate in int32/int64; one "
                               "f32 sum caps exact totals at 2^24")
            recv = node.func.value if isinstance(node.func,
                                                 ast.Attribute) else None
            if func_name == "sum" and _is_float_cast(recv):
                self._emit(node, "float-count-accum",
                           "a float cast feeding .sum() — count totals "
                           "must not round-trip through floats")
        self.generic_visit(node)

    # -- sentinel-literal ----------------------------------------------

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if (isinstance(node.op, ast.USub)
                and isinstance(node.operand, ast.Constant)
                and node.operand.value == _SENTINEL_MAGNITUDE):
            self._emit(node, "sentinel-literal",
                       "literal -0x7FFFFFFF — derive sentinels from "
                       "relation.SENTINEL so they stay in one place")
        self.generic_visit(node)


def lint_file(path: Path, root: Path | None = None) -> list[str]:
    """Lint one file; findings as ``path:line: [rule] message``."""
    rel = path.as_posix()
    if root is not None:
        try:
            rel = path.relative_to(root).as_posix()
        except ValueError:
            pass
    tree = ast.parse(path.read_text(), filename=str(path))
    v = _Visitor(path.as_posix())
    v.visit(tree)
    return [f"{rel}:{line}: [{rule}] {msg}"
            for line, rule, msg in sorted(v.findings)]


def lint_paths(paths) -> list[str]:
    """Lint every ``.py`` file under each path (file or directory)."""
    findings: list[str] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f, root=Path.cwd()))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        argv = ["src/repro_torch"]
    findings = lint_paths(argv)
    for f in findings:
        print(f)
    print(f"port invariant lint: {len(findings)} finding(s) over {argv}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
