"""torchlint — an AST linter for the port's invariants (port of
``repro.analysis.lint``, the reference's jaxlint).

The reference's six rules encode invariants of the delayed-gradient
executor and the serving stack that no off-the-shelf linter knows about.
They hold in the port too, stated in PyTorch's idiom: a compiled or
captured callable is not re-specialised every iteration; a host buffer
handed to an asynchronous copy is not written while the card may still
read it; every draw consumes a fresh key (and never the global
generator); step bodies do not sync with the host; an in-place kernel
tells autograd that it wrote; mesh axes exist.  Each rule is a syntactic
pattern tight enough to run clean over the port's tree
(``scripts/torch_lint.py src/repro_torch examples/torch_*.py
scripts/torch_*.py chip_smoke.py``) while firing on the seeded violations
in ``tests/fixtures/torchlint``:

========  ==============================================================
TL001     recompile hazard (JL001): a loop-varying Python scalar
          (``int()``, ``len()``, ``.shape[...]``, ``.size(...)``) passed,
          inside a loop, to a callable compiled or captured for fixed
          shapes (``torch.compile``, ``torch.jit.script`` / ``trace``,
          ``torch.cuda.make_graphed_callables``) — every iteration
          recompiles or re-captures.
TL002     async-copy source written (JL002): a host tensor is the source
          of a ``non_blocking=True`` copy (``.to``, ``.cuda``, ``.copy_``)
          and is written again in the same function (an in-place method,
          a subscript store, ``+=``, ``out=``) before a synchronisation
          (``torch.cuda.synchronize``, ``.synchronize()``, ``.wait()``,
          ``wait_stream`` / ``wait_event``) — the card may still be
          reading it.  A loop's body is read round to the copy again.
TL003     RNG discipline (JL003): (a) one key consumed by two draws of
          ``repro_torch.kernels.rng`` (``jax_normal``, ``jax_uniform``,
          ``randint``, ``random_bits``, ``normal``, ``seed_int``, ...) at
          the same counters with no rebinding of the key between them
          (``split`` / ``fold_in``), along any path through the branches
          and round a loop; (b) a draw from the global generator
          (``torch.randn`` / ``rand`` / ``randint`` / ``randperm`` /
          ``normal`` / ``bernoulli`` / ``multinomial``, their ``_like``
          forms, ``Tensor.normal_`` / ``uniform_`` / ``random_`` and the
          ``nn.init`` draws) with no ``generator=``.
TL004     host sync in hot code (JL004): ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``.synchronize()``, a
          scalar coercion of a tensor, or an ``if`` / ``while`` /
          ``assert`` on a tensor, inside a ``torch.autograd.Function``'s
          ``forward`` / ``backward``, a ``torch.compile``d function, or a
          ``def`` that carries ``# torchlint: hot`` (and the defs nested in
          them) — what a CUDA-graph capture refuses.
TL005     in-place kernel without a version bump (JL005): a foreign
          function (an attribute of a ``ctypes.CDLL`` / ``build.load``
          library) is passed ``t.data_ptr()`` of a parameter ``t`` that
          the function hands back (the in-place convention), and the
          function does not call ``torch.autograd.graph.increment_version
          (t)`` (or ``ctx.mark_dirty(t)``) after the launch — a backward
          that saved ``t`` would read the new values without an error.
TL006     mesh axis not in the mesh (JL006): an axis name used against a
          statically visible mesh (``DeviceMesh(..., mesh_dim_names=)``,
          ``init_device_mesh(..., mesh_dim_names=)``, ``launch.mesh.
          _mesh(shape, names)``, ``make_debug_mesh``) that does not define
          it: ``mesh.get_group("x")``, ``mesh["x"]``,
          ``get_local_rank("x")``, ``axis_size(mesh, "x")``, and spec
          tuples passed to ``sanitize_spec`` / ``named``.
========  ==============================================================

The port marks these step bodies hot: the step closures of
``launch/steps.py::make_sgld_train_step`` (and their ``update``), the
gradient functions of ``train/loop.py::make_grad_fn``, the update closures
of the sampler transforms (``samplers/transforms.py``) and
``Model.serve_step``.

False positives are suppressed inline, with a reason::

    bad = flags.cpu()  # torchlint: disable=TL004 (the commit's one read)
    # torchlint: disable-file=TL003   (anywhere in the file, whole file)

Suppressed findings are recorded, not dropped.  The linter is pure stdlib
``ast`` — it imports neither torch nor the linted code.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence

__all__ = ["Finding", "RULES", "REFERENCE", "lint_source", "lint_file",
           "lint_paths"]

RULES = {
    "TL001": "recompile hazard: loop-varying Python scalar in a compiled call",
    "TL002": "async-copy source written before a synchronisation",
    "TL003": "RNG key reuse, or a draw from the global generator",
    "TL004": "host sync inside hot code",
    "TL005": "in-place kernel launch without an autograd version bump",
    "TL006": "mesh axis not in the mesh",
}

#: the reference's rule each port rule states in PyTorch's idiom
REFERENCE = {f"TL00{i}": f"JL00{i}" for i in range(1, 7)}

_PRAGMA = re.compile(r"#\s*torchlint:\s*(disable(?:-file)?)\s*=\s*"
                     r"([A-Za-z0-9_,\s]+)")
_HOT = re.compile(r"#\s*torchlint:\s*hot\b")

#: scalar coercions that force a host sync when applied to a tensor
_SCALAR_COERCIONS = {"int", "float", "bool", "complex"}
#: callables compiled or captured for fixed shapes
_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.cuda.make_graphed_callables"}
#: draws of ``repro_torch.kernels.rng``: name -> positional indices of the
#: arguments that place the draw's counters (``start``, ``block``); two
#: draws under one key at the same counters give the same numbers
_RNG = "repro_torch.kernels.rng."
_RNG_DRAWS = {"jax_normal": (3, 4), "jax_uniform": (5, 6), "randint": (4,),
              "random_bits": (3,), "normal": (1,), "seed_int": (),
              "_bits_at": (1,), "_bits32_at": (1,)}
_COUNTER_KWARGS = ("start", "block", "counters")
#: torch draws that fall back on the global generator without generator=
_GLOBAL_DRAWS = {"randn", "rand", "randint", "randperm", "normal", "bernoulli",
                 "multinomial", "poisson", "randn_like", "rand_like",
                 "randint_like"}
_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "exponential_",
                  "bernoulli_", "cauchy_", "geometric_", "log_normal_",
                  "kaiming_normal_", "kaiming_uniform_", "xavier_normal_",
                  "xavier_uniform_", "trunc_normal_", "orthogonal_"}
#: host reads of a tensor (TL004)
_HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: synchronisation points after which a copy's source is free (TL002)
_SYNCS = {"synchronize", "wait", "wait_stream", "wait_event"}
#: tensor attributes and methods that read metadata only (no sync)
_METADATA = {"shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
             "layout", "names", "is_leaf", "grad_fn", "dim", "size", "numel",
             "element_size", "is_contiguous", "is_floating_point", "stride",
             "nelement", "get_device", "data_ptr", "storage_offset", "item",
             "tolist", "is_complex", "is_sparse", "untyped_storage"}
#: torch.* callables that return no tensor
_TORCH_HOST = ("torch.cuda.", "torch.distributed.", "torch.backends.",
               "torch.device", "torch.dtype", "torch.Size", "torch.finfo",
               "torch.iinfo", "torch.get_", "torch.numel", "torch.is_",
               "torch.are_", "torch.autograd.", "torch.no_grad",
               "torch.enable_grad", "torch.inference_mode")
_LOADERS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary",
            "repro_torch.kernels.build.load"}
_MESH_BUILDERS = {"DeviceMesh", "init_device_mesh", "_mesh", "make_debug_mesh"}
_DEBUG_MESH_AXES = ("data", "model")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}{tag}"


# --------------------------------------------------------------------------
# pragma collection
# --------------------------------------------------------------------------

def _pragmas(source: str):
    """-> (per-line {lineno: set of rules}, file-wide set of rules).

    ``# torchlint: disable=TL001[,TL002]`` suppresses on its physical line;
    ``# torchlint: disable-file=TL001`` (or ``=all``) suppresses file-wide.
    """
    per_line: dict[int, set] = {}
    file_wide: set = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA.search(tok.string)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(2).split(",")
                     if r.strip()}
            if "ALL" in rules:
                rules = set(RULES)
            if m.group(1) == "disable-file":
                file_wide |= rules
            else:
                per_line.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass
    return per_line, file_wide


def _hot_lines(source: str) -> set:
    """Physical lines that carry ``# torchlint: hot``."""
    out: set = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT and _HOT.search(tok.string):
                out.add(tok.start[0])
    except tokenize.TokenError:
        pass
    return out


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------

def _dotted(node: ast.AST, aliases: dict) -> Optional[str]:
    """Resolve ``rng.normal`` / ``repro_torch.kernels.rng.normal`` /
    ``normal`` to a full dotted path using the file's import aliases; None
    when not a name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    head = aliases.get(parts[0], parts[0])
    return ".".join([head] + parts[1:])


def _import_aliases(tree: ast.Module) -> dict:
    """{local name: dotted path} for every import in the module."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _assigned_names(node: ast.AST) -> set:
    """Names bound anywhere under ``node`` (assign/aug/ann/for/with/walrus)."""
    out: set = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def _last_attr(node: ast.AST) -> Optional[str]:
    """``self._run`` -> ``_run``; ``name`` -> ``name``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _leaf(path: Optional[str]) -> str:
    return (path or "").rsplit(".", 1)[-1]


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_TERMINATORS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _own_nodes(stmt: ast.AST) -> list:
    """The nodes of ``stmt`` itself in source order, not those of the
    statements nested in its body, and not those inside a lambda or a
    nested def."""
    out = []

    def visit(node):
        for _, value in ast.iter_fields(node):
            if isinstance(value, list) and value and isinstance(
                    value[0], ast.stmt):
                continue  # a nested statement list: not ours
            for sub in (value if isinstance(value, list) else [value]):
                if isinstance(sub, ast.AST) and not isinstance(
                        sub, (ast.Lambda,) + _FUNCS):
                    out.append(sub)
                    visit(sub)
    visit(stmt)
    out.sort(key=lambda n: (getattr(n, "lineno", 0), getattr(n, "col_offset", 0)))
    return out


def _flat_statements(fn) -> list:
    """The function's statements in source order (branch bodies flattened;
    nested defs excluded — they are separate scopes)."""
    out = []

    def visit(body):
        for stmt in body:
            if isinstance(stmt, _FUNCS + (ast.ClassDef,)):
                continue
            out.append(stmt)
            for _, value in ast.iter_fields(stmt):
                if isinstance(value, list) and value and \
                        isinstance(value[0], ast.stmt):
                    visit(value)
    visit(fn.body)
    return out


# --------------------------------------------------------------------------
# the linter
# --------------------------------------------------------------------------

class _FileLinter:
    def __init__(self, tree: ast.Module, source: str, path: str):
        self.tree = tree
        self.path = path
        self.aliases = _import_aliases(tree)
        self.source = source
        self.findings: list[Finding] = []
        self.per_line, self.file_wide = (_pragmas(source) if "torchlint" in source
                                         else ({}, set()))
        self.hot_lines = _hot_lines(source) if _HOT.search(source) else set()
        self.funcs = [n for n in ast.walk(tree) if isinstance(n, _FUNCS)]
        # names bound to compiled / captured callables, and compiled defs
        self.compiled_names: set = set()
        self.hot_funcs: set = set()
        self.autograd_methods: set = set()

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        suppressed = (rule in self.file_wide
                      or rule in self.per_line.get(line, ()))
        self.findings.append(Finding(
            rule=rule, path=self.path, line=line,
            col=getattr(node, "col_offset", 0) + 1, message=message,
            suppressed=suppressed))

    def path_of(self, node: ast.AST) -> str:
        return _dotted(node, self.aliases) or ""

    # -- pass 1: compiled callables and hot functions -------------------------
    def _is_compiler(self, node: ast.AST) -> bool:
        """``torch.compile``, ``torch.compile(mode=...)``,
        ``partial(torch.compile, ...)`` and the other compilers."""
        if self.path_of(node) in _COMPILERS:
            return True
        if isinstance(node, ast.Call):
            head = self.path_of(node.func)
            if head in ("functools.partial", "partial") and node.args:
                return self._is_compiler(node.args[0])
            return self._is_compiler(node.func) and not node.args
        return False

    def collect(self) -> None:
        defs: dict[str, list] = {}
        for fn in self.funcs:
            defs.setdefault(fn.name, []).append(fn)
            if any(self._is_compiler(d) for d in fn.decorator_list):
                self.compiled_names.add(fn.name)
                self.hot_funcs.add(fn)
            if self._carries_hot(fn):
                self.hot_funcs.add(fn)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef) and any(
                    self.path_of(b).endswith("autograd.Function")
                    for b in node.bases):
                for sub in node.body:
                    if isinstance(sub, _FUNCS) and sub.name in ("forward",
                                                                "backward"):
                        self.hot_funcs.add(sub)
                        self.autograd_methods.add(sub)
            if not (isinstance(node, ast.Call)
                    and self.path_of(node.func) in _COMPILERS and node.args):
                continue
            targets = node.args[0].elts if isinstance(
                node.args[0], (ast.Tuple, ast.List)) else [node.args[0]]
            for t in targets:
                for d in defs.get(_last_attr(t) or "", ()):
                    self.hot_funcs.add(d)
            parent = getattr(node, "_torchlint_parent", None)
            if isinstance(parent, ast.Assign):
                for tgt in parent.targets:
                    elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                        else [tgt]
                    self.compiled_names |= {_last_attr(e) for e in elts} - {None}
        # nested defs inside a hot function are hot too
        for fn in list(self.hot_funcs):
            for sub in ast.walk(fn):
                if isinstance(sub, _FUNCS):
                    self.hot_funcs.add(sub)

    def _carries_hot(self, fn) -> bool:
        """The pragma on the line above the def (or its decorators) or on
        any line of its signature."""
        first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
        return any(line in self.hot_lines
                   for line in range(first - 1, fn.body[0].lineno))

    # -- driving -------------------------------------------------------------
    def run(self) -> list[Finding]:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._torchlint_parent = node
        self.collect()
        self.check_tl001()
        self.check_tl002()
        self.check_tl003()
        self.check_tl004()
        self.check_tl005()
        self.check_tl006()
        deduped, seen = [], set()
        for f in self.findings:
            key = (f.rule, f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                deduped.append(f)
        deduped.sort(key=lambda f: (f.line, f.col, f.rule))
        self.findings = deduped
        return self.findings

    # -- TL001: recompile hazard ------------------------------------------------
    def check_tl001(self) -> None:
        if not self.compiled_names:
            return
        for loop in ast.walk(self.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            varying = _assigned_names(loop)
            if isinstance(loop, (ast.For, ast.AsyncFor)):
                varying |= _names_in(loop.target)
            for call in ast.walk(loop):
                if not isinstance(call, ast.Call):
                    continue
                callee = _last_attr(call.func)
                if callee not in self.compiled_names:
                    continue
                for arg in list(call.args) + [k.value for k in call.keywords]:
                    if self._scalarish(arg, varying):
                        self.emit(
                            "TL001", call,
                            f"compiled `{callee}` called in a loop with a "
                            "loop-varying Python scalar argument — every "
                            "distinct value recompiles (or re-captures); pass "
                            "a tensor or bucket the value")
                        break

    def _scalarish(self, node: ast.AST, varying: set) -> bool:
        """A Python-scalar expression whose value changes across the loop:
        int()/len()/... coercions, ``.shape`` / ``.size(...)`` reads, or
        arithmetic on them."""
        if isinstance(node, ast.Call):
            head = self.path_of(node.func)
            if head in (_SCALAR_COERCIONS | {"len", "round"}):
                return bool(_names_in(node) & varying)
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "size", "dim", "numel", "item"):
                return bool(_names_in(node) & varying)
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            src = ast.unparse(node)
            if ".shape" in src or ".ndim" in src:
                return bool(_names_in(node) & varying)
        if isinstance(node, ast.BinOp):
            return (self._scalarish(node.left, varying)
                    or self._scalarish(node.right, varying))
        return False

    # -- TL002: async-copy source written before a sync -------------------------
    def check_tl002(self) -> None:
        if "non_blocking" not in self.source:
            return
        for fn in self.funcs:
            stmts = _flat_statements(fn)
            for i, stmt in enumerate(stmts):
                for call in (n for n in _own_nodes(stmt)
                             if isinstance(n, ast.Call)):
                    src = self._async_source(call)
                    if src is not None:
                        self._flag_writes_after(fn, stmts, i, src)

    def _async_source(self, call: ast.Call) -> Optional[str]:
        """The name a ``non_blocking=True`` copy reads from, else None."""
        if not (isinstance(call.func, ast.Attribute)
                and _is_true(_kwarg(call, "non_blocking"))):
            return None
        if call.func.attr in ("to", "cuda"):
            src = call.func.value
        elif call.func.attr == "copy_":
            src = call.args[0] if call.args else _kwarg(call, "src")
        else:
            return None
        return src.id if isinstance(src, ast.Name) else None

    def _flag_writes_after(self, fn, stmts, idx, name) -> None:
        """Walk what runs after the copy — the rest of its loop's body, the
        body again up to the copy, then the rest of the function — until a
        sync or a rebinding of ``name``; flag the first write."""
        copy = stmts[idx]
        loop, node = None, getattr(copy, "_torchlint_parent", None)
        while node is not None and node is not fn:
            if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                loop = node
                break
            node = getattr(node, "_torchlint_parent", None)
        inside = set(map(id, ast.walk(loop))) if loop is not None else set()
        after = [s for s in stmts[idx + 1:] if id(s) in inside]
        wrap = [s for s in stmts[:idx] if id(s) in inside]
        rest = [s for s in stmts[idx + 1:] if id(s) not in inside]
        # the copy's own statement may rebind the name
        if name in {n.id for n in _own_nodes(copy)
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}:
            return
        for stmt in after + wrap + rest:
            for sub in [stmt] + _own_nodes(stmt):
                if isinstance(sub, ast.Call) and self._is_sync(sub):
                    return
                if self._writes(sub, name):
                    self.emit(
                        "TL002", sub,
                        f"`{name}` is the source of a non_blocking copy at "
                        f"line {copy.lineno} and is written here before any "
                        "synchronisation — the card may still be reading it; "
                        "copy from a fresh buffer or synchronise first")
                    return
            if name in {n.id for n in _own_nodes(stmt)
                        if isinstance(n, ast.Name)
                        and isinstance(n.ctx, ast.Store)}:
                return

    def _is_sync(self, call: ast.Call) -> bool:
        return (self.path_of(call.func) == "torch.cuda.synchronize"
                or (isinstance(call.func, ast.Attribute)
                    and call.func.attr in _SYNCS))

    @staticmethod
    def _writes(node: ast.AST, name: str) -> bool:
        """``name.op_(...)``, ``name[...] = ...``, ``name += ...``,
        ``f(..., out=name)``."""
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == name and f.attr.endswith("_")
                    and not f.attr.startswith("_")
                    and f.attr != "requires_grad_"):
                return True
            out = _kwarg(node, "out")
            return isinstance(out, ast.Name) and out.id == name
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                          else [t]):
                    if (isinstance(e, ast.Subscript)
                            and isinstance(e.value, ast.Name)
                            and e.value.id == name):
                        return True
                    if (isinstance(node, ast.AugAssign)
                            and isinstance(e, ast.Name) and e.id == name):
                        return True
        return False

    # -- TL003: RNG discipline ----------------------------------------------------
    def check_tl003(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._global_draw(node)
        if not any(v.startswith("repro_torch") for v in self.aliases.values()):
            return  # no rng draw can be named
        for scope in self.funcs + [self.tree]:
            self._key_flow(scope.body, {})

    def _global_draw(self, call: ast.Call) -> None:
        gen = _kwarg(call, "generator")
        if gen is not None and not (isinstance(gen, ast.Constant)
                                    and gen.value is None):
            return
        path = self.path_of(call.func)
        if path.startswith("torch.") and path.count(".") == 1 \
                and _leaf(path) in _GLOBAL_DRAWS:
            what = path
        elif isinstance(call.func, ast.Attribute) \
                and call.func.attr in _INPLACE_DRAWS:
            what = f".{call.func.attr}"
        else:
            return
        self.emit("TL003", call,
                  f"`{what}` with no generator= draws from the global "
                  "generator — pass a torch.Generator seeded from the "
                  "run's key")

    def _draw_of(self, call: ast.Call):
        """-> (key name, counter signature) of an rng draw, else None."""
        path = self.path_of(call.func)
        if not path.startswith(_RNG) or _leaf(path) not in _RNG_DRAWS:
            return None
        key = call.args[0] if call.args else (_kwarg(call, "key")
                                              or _kwarg(call, "seed"))
        if not isinstance(key, ast.Name):
            return None
        where = [call.args[i] for i in _RNG_DRAWS[_leaf(path)]
                 if i < len(call.args)]
        where += [kw.value for kw in call.keywords
                  if kw.arg in _COUNTER_KWARGS]
        return key.id, tuple(ast.unparse(w) for w in where)

    def _expr_events(self, node: ast.AST, live: dict) -> None:
        """Draws and stores of one expression (or simple statement), in
        the order they run: a call's arguments before the call, a
        comprehension's generators before its element; lambdas and nested
        defs are skipped (they run later, in their own scope)."""
        if isinstance(node, (ast.Lambda,) + _FUNCS + (ast.ClassDef,)):
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self._expr_events(gen.iter, live)
                self._rebind(_names_in(gen.target), live)
                for cond in gen.ifs:
                    self._expr_events(cond, live)
            elts = [node.key, node.value] if isinstance(node, ast.DictComp) \
                else [node.elt]
            for e in elts:
                self._expr_events(e, live)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.NamedExpr)):
            if node.value is not None:
                self._expr_events(node.value, live)
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                self._expr_events(t, live)
            return
        for child in ast.iter_child_nodes(node):
            self._expr_events(child, live)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            self._rebind({node.id}, live)
        elif isinstance(node, ast.Call):
            draw = self._draw_of(node)
            if draw is None:
                return
            if draw in live:
                line = live[draw]
                where = (f"line {line}" if line != node.lineno
                         else "this line on the loop's previous iteration")
                self.emit(
                    "TL003", node,
                    f"key `{draw[0]}` already consumed by an rng draw at "
                    f"{where} at the same counters — the two draws are "
                    "identical; split or fold_in between them")
            else:
                live[draw] = node.lineno

    @staticmethod
    def _rebind(names: set, live: dict) -> None:
        """A store to a name kills the draws of that key and those whose
        counters it places."""
        for draw in list(live):
            key, where = draw
            if key in names or any(
                    names & {n for n in re.findall(r"[A-Za-z_]\w*", w)}
                    for w in where):
                del live[draw]

    def _key_flow(self, body: list, live: dict) -> Optional[dict]:
        """Run ``body`` from the draws ``live`` ({(key, counters): line});
        returns the draws live after it, or None where every path left it
        (return, raise, break, continue).  Branches merge by union, a loop
        runs its body twice (the second pass finds draws carried round)."""
        for stmt in body:
            if isinstance(stmt, _FUNCS + (ast.ClassDef,)):
                self._rebind({stmt.name}, live)
                continue
            if isinstance(stmt, ast.If):
                self._expr_events(stmt.test, live)
                live = self._merge(self._key_flow(stmt.body, dict(live)),
                                   self._key_flow(stmt.orelse, dict(live)))
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                head = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                    else stmt.test
                self._expr_events(head, live)
                state = dict(live)
                for _ in range(2):
                    if isinstance(stmt, (ast.For, ast.AsyncFor)):
                        self._rebind(_names_in(stmt.target), state)
                    out = self._key_flow(stmt.body, dict(state))
                    state = self._merge(state, out) or state
                live = self._merge(state, self._key_flow(stmt.orelse,
                                                         dict(state)))
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._expr_events(item, live)
                live = self._key_flow(stmt.body, live)
            elif isinstance(stmt, ast.Try):
                after = self._key_flow(stmt.body, dict(live))
                state = self._merge(live, after) or dict(live)
                outs = [self._key_flow(stmt.orelse, dict(after))
                        if after is not None else None]
                outs += [self._key_flow(h.body, dict(state))
                         for h in stmt.handlers]
                live = None
                for o in outs:
                    live = self._merge(live, o)
                if stmt.finalbody:
                    live = self._key_flow(stmt.finalbody,
                                          live if live is not None else state)
            else:
                self._expr_events(stmt, live)
                if isinstance(stmt, _TERMINATORS):
                    return None
            if live is None:
                return None
        return live

    @staticmethod
    def _merge(a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
        if a is None:
            return b
        if b is None:
            return a
        return {**b, **a}

    # -- TL004: host sync in hot code ---------------------------------------------
    def check_tl004(self) -> None:
        seen: set = set()
        for fn in self.hot_funcs:
            tensors = self._tensor_names(fn)
            for node in ast.walk(fn):
                if id(node) in seen:
                    continue
                msg = None
                if isinstance(node, ast.Call):
                    msg = self._host_read(node, tensors)
                elif isinstance(node, (ast.If, ast.While, ast.IfExp,
                                       ast.Assert)):
                    if self._tensorish(node.test, tensors):
                        msg = (f"`{type(node).__name__.lower()}` on a tensor "
                               "in hot code reads it on the host (a sync a "
                               "CUDA graph cannot capture); use torch.where "
                               "or keep the branch on the host's values")
                if msg:
                    seen.add(id(node))
                    self.emit("TL004", node, msg)

    def _tensor_names(self, fn) -> set:
        """Parameters annotated as tensors (and every gradient an autograd
        Function's ``backward`` takes), and locals assigned from tensor
        expressions, in statement order."""
        args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        grads = fn in self.autograd_methods and fn.name == "backward"
        out = set()
        for i, a in enumerate(args):
            ann = self.path_of(a.annotation) if a.annotation is not None else ""
            if _leaf(ann) == "Tensor" or (grads and i > 0
                                          and a.annotation is None):
                out.add(a.arg)
        for stmt in _flat_statements(fn):
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                if self._tensorish(stmt.value, out):
                    out.add(stmt.targets[0].id)
                else:
                    out.discard(stmt.targets[0].id)
        return out

    def _tensorish(self, node: ast.AST, tensors: set) -> bool:
        """True where ``node`` evaluates to a tensor whose truth or value a
        host read would need (metadata reads such as ``.shape`` do not)."""
        if isinstance(node, ast.Name):
            return node.id in tensors
        if isinstance(node, ast.Attribute):
            return (node.attr in ("T", "mT", "data", "grad", "real", "imag")
                    and self._tensorish(node.value, tensors))
        if isinstance(node, ast.Subscript):
            return self._tensorish(node.value, tensors)
        if isinstance(node, ast.Call):
            path = self.path_of(node.func)
            if path.startswith("torch.") and not path.startswith(_TORCH_HOST):
                return True
            f = node.func
            return (isinstance(f, ast.Attribute) and f.attr not in _METADATA
                    and self._tensorish(f.value, tensors))
        if isinstance(node, ast.BinOp):
            return (self._tensorish(node.left, tensors)
                    or self._tensorish(node.right, tensors))
        if isinstance(node, ast.UnaryOp):
            return self._tensorish(node.operand, tensors)
        if isinstance(node, ast.BoolOp):
            return any(self._tensorish(v, tensors) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self._tensorish(v, tensors)
                       for v in [node.left] + node.comparators)
        return False

    def _host_read(self, call: ast.Call, tensors: set) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
            return (f"`.{f.attr}()` in hot code waits for the card (a sync a "
                    "CUDA graph cannot capture); keep the value on the "
                    "device or read it in the host loop")
        if isinstance(f, ast.Attribute) and f.attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in call.args + [k.value for k in call.keywords]):
            return ("`.to(\"cpu\")` in hot code waits for the card; keep the "
                    "value on the device or read it in the host loop")
        path = self.path_of(f)
        if path in _SCALAR_COERCIONS and call.args and self._tensorish(
                call.args[0], tensors):
            return (f"`{path}()` of a tensor in hot code reads it on the "
                    "host (a sync); keep it as a tensor")
        return None

    # -- TL005: in-place kernel without a version bump ----------------------------
    def check_tl005(self) -> None:
        if "data_ptr" not in self.source:
            return
        loaders = self._loader_funcs()
        for fn in self.funcs:
            libs = self._lib_names(fn, loaders)
            params = {a.arg for a in fn.args.posonlyargs + fn.args.args
                      + fn.args.kwonlyargs}
            returned = self._returned_names(fn)
            bumped = self._bumped(fn)
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and self._is_lib(call.func.value, libs, loaders)):
                    continue
                for name in sorted(self._pointer_args(call)):
                    if name not in params or name not in returned:
                        continue
                    if any(line > call.lineno for line in bumped.get(name, ())):
                        continue
                    self.emit(
                        "TL005", call,
                        f"`{call.func.attr}` writes `{name}` in place through "
                        "its data_ptr() and the function hands it back, but "
                        "autograd is not told: call torch.autograd.graph."
                        f"increment_version({name}) after the launch (or "
                        f"ctx.mark_dirty({name}))")

    def _loader_funcs(self) -> set:
        """Module functions that return a loaded library."""
        out = set()
        for fn in self.funcs:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        self.path_of(node.func) in _LOADERS:
                    out.add(fn.name)
                    break
        return out

    def _lib_names(self, fn, loaders: set) -> set:
        return {_last_attr(node.targets[0]) for node in ast.walk(fn)
                if isinstance(node, ast.Assign) and len(node.targets) == 1
                and self._is_lib(node.value, set(), loaders)} - {None}

    def _is_lib(self, node: ast.AST, libs: set, loaders: set) -> bool:
        if isinstance(node, ast.Name):
            return node.id in libs
        if isinstance(node, ast.Call):
            path = self.path_of(node.func)
            return path in _LOADERS or (isinstance(node.func, ast.Name)
                                        and node.func.id in loaders)
        return False

    @staticmethod
    def _pointer_args(call: ast.Call) -> set:
        return {n.func.value.id for a in call.args + [k.value for k in
                                                     call.keywords]
                for n in ast.walk(a)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "data_ptr"
                and isinstance(n.func.value, ast.Name)}

    @staticmethod
    def _returned_names(fn) -> set:
        out = set()
        for node in _flat_statements(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                elts = node.value.elts if isinstance(
                    node.value, (ast.Tuple, ast.List)) else [node.value]
                out |= {e.id for e in elts if isinstance(e, ast.Name)}
        return out

    def _bumped(self, fn) -> dict:
        """{name: lines} of ``increment_version(name)`` /
        ``ctx.mark_dirty(name)`` calls."""
        out: dict = {}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            path = self.path_of(node.func)
            if not (path.endswith("autograd.graph.increment_version")
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "mark_dirty")):
                continue
            for a in node.args:
                for n in _names_in(a):
                    out.setdefault(n, []).append(node.lineno)
        return out

    # -- TL006: mesh axis not in the mesh -------------------------------------------
    def check_tl006(self) -> None:
        if not any(b in self.source for b in _MESH_BUILDERS):
            return
        meshes = self._static_meshes()
        if not meshes:
            return
        for node in ast.walk(self.tree):
            uses = self._axis_uses(node)
            for mesh_node, axis_nodes in uses:
                if not isinstance(mesh_node, ast.Name):
                    continue
                axes = meshes.get(mesh_node.id)
                if axes is None:
                    continue
                for a in axis_nodes:
                    for used in sorted(self._literal_axes(a)):
                        if used not in axes:
                            self.emit(
                                "TL006", node,
                                f"axis {used!r} is used against mesh "
                                f"`{mesh_node.id}`, which only defines "
                                f"{sorted(axes)} — the lookup fails, or the "
                                "dimension silently replicates")

    def _axis_uses(self, node: ast.AST) -> list:
        """[(mesh expression, [axis-name expressions])] at ``node``."""
        if isinstance(node, ast.Subscript):
            return [(node.value, [node.slice])]
        if not isinstance(node, ast.Call):
            return []
        f, leaf = node.func, _leaf(self.path_of(node.func))
        if isinstance(f, ast.Attribute) and f.attr in ("get_group",
                                                       "get_local_rank"):
            return [(f.value, node.args[:1])]
        if leaf == "axis_size" and len(node.args) >= 2:
            return [(node.args[0], [node.args[1]])]
        if leaf == "named" and len(node.args) >= 2:
            return [(node.args[0], [node.args[1]])]
        if leaf == "sanitize_spec" and node.args:
            mesh = node.args[2] if len(node.args) >= 3 else _kwarg(node, "mesh")
            return [(mesh, [node.args[0]])] if mesh is not None else []
        return []

    @staticmethod
    def _literal_axes(node: ast.AST) -> set:
        """Axis-name literals: the string itself, or the strings inside
        spec tuples (not a dict's keys)."""
        elts = [node] + [e for n in ast.walk(node)
                         if isinstance(n, (ast.Tuple, ast.List)) for e in n.elts]
        return {e.value for e in elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)}

    def _static_meshes(self) -> dict:
        """{name: set of axis names} for meshes built with literal axis
        names anywhere in the file."""
        out: dict = {}
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            call = node.value
            leaf = _leaf(self.path_of(call.func))
            if leaf not in _MESH_BUILDERS:
                continue
            if leaf == "make_debug_mesh":
                out[node.targets[0].id] = set(_DEBUG_MESH_AXES)
                continue
            axis_arg = _kwarg(call, "mesh_dim_names")
            if axis_arg is None and leaf == "_mesh" and len(call.args) >= 2:
                axis_arg = call.args[1]
            if axis_arg is None:
                continue
            try:
                axes = ast.literal_eval(axis_arg)
            except (ValueError, SyntaxError):
                continue
            if isinstance(axes, str):
                axes = (axes,)
            if isinstance(axes, (tuple, list)) and all(
                    isinstance(a, str) for a in axes):
                out[node.targets[0].id] = set(axes)
        return out


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one source string; returns every finding (``suppressed`` marks
    pragma-silenced ones)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="TL000", path=path, line=e.lineno or 1,
                        col=(e.offset or 0) + 1,
                        message=f"syntax error: {e.msg}")]
    return _FileLinter(tree, source, path).run()


def lint_file(path) -> list[Finding]:
    p = Path(path)
    return lint_source(p.read_text(), str(p))


def lint_paths(paths: Sequence, *,
               exclude: Iterable[str] = ()) -> list[Finding]:
    """Lint every ``*.py`` under ``paths`` (files or directories)."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    exclude = tuple(exclude)
    findings: list[Finding] = []
    for f in files:
        if any(part in exclude for part in f.parts):
            continue
        findings.extend(lint_file(f))
    return findings
