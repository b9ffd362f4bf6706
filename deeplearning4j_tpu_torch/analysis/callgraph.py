"""Whole-repo symbol table and conservative call graph for the port's
linter (counterpart of ``deeplearning4j_tpu/analysis/callgraph.py``).

The per-file rules in ``analysis/lint.py`` see one module at a time, so a
helper that calls ``.item()`` or draws from the global RNG two modules away
from a training step is invisible to them, and the lock-order rule
(DLT004) cannot see a deadlock whose two halves live in two classes in two
files. This module is what the interprocedural rules (DLT017/018/019)
stand on:

- **Module summaries, cached by content hash.** Each ``.py`` file is parsed
  once into a :class:`ModuleSummary`: functions (nested functions, lambdas
  handed to a step-root call, and the module body itself as a
  pseudo-function), classes with their bases and ``self.<attr>`` type and
  lock assignments, import aliases, and per-function facts: raw call sites
  with the locks held at each, host-work hazards, lock acquisitions
  (``with`` blocks and explicit ``acquire()`` / ``release()``), blocking
  calls, thread starts and joins, and waiver comments. Summaries are plain
  data keyed by ``(path, sha1(content))``, so a warm ``lint_paths`` re-reads
  and re-hashes files but never re-parses an unchanged one.

- **Conservative name resolution.** Module-level functions through import
  aliases (one-hop re-exports through package ``__init__`` files and
  relative imports included), ``self._method(...)`` with inherited methods
  through resolved bases, ``self.<attr>.method(...)`` / ``var.method(...)``
  through constructor assignments (``self.x = Foo(...)``), ``super()``,
  ``functools.partial(f, ...)``, callables handed to a step-root call, and
  ``threading.Thread(target=...)``. A receiver whose type cannot be
  established gives NO edge: the graph under-approximates, so every chain
  it reports exists in the source.

- **Step roots.** Where the JAX package has traced entries (functions
  jitted or handed to a tracing transform), the port has the functions
  that run once per step or per dispatch on the device path:

  - callables passed to ``CompileWatch.wrap(fn, key)`` (a receiver named
    ``*watch``) or to a network's ``_watched(key, fn)``: the port's
    counterparts of the functions the JAX package jits;
  - ``forward`` / ``backward`` of every ``torch.autograd.Function``
    subclass;
  - the launch functions of the kernel wrappers (a function in
    ``perf/kernels/`` that counts its launches, ``global launches``);
  - targets of ``torch.compile``, ``torch.func.*``, ``torch.vmap``,
    ``torch.cuda.make_graphed_callables`` and the calls made inside a
    ``with torch.cuda.graph(...)`` capture. The port has none of these
    today; they are listed so that a later use is seen.

  :meth:`CallGraph.reachable_from_entries` yields each function reachable
  from a root with its full root→…→function chain (the DLT017 message).

Build with :func:`build_graph`; clear the caches (for cold-run timing) with
:func:`clear_cache`.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "CallGraph", "ModuleSummary", "FunctionFacts", "ClassFacts",
    "build_graph", "summarize_file", "summarize_source", "clear_cache",
    "discover_files", "STEP_ROOT_CALLS", "sync_of", "rng_of", "is_tensor_expr",
]

# Calls whose callable arguments become step roots (matched against the
# alias-resolved dotted path and the literal text, the lint.py convention;
# ``torch.func.*`` by prefix).
STEP_ROOT_CALLS = frozenset({
    "torch.compile", "torch.vmap", "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
})
_STEP_ROOT_PREFIXES = ("torch.func.",)
_AUTOGRAD_FUNCTION = frozenset({"torch.autograd.Function",
                                "torch.autograd.function.Function"})


def is_step_root_call(q: str, short: str) -> bool:
    return (q in STEP_ROOT_CALLS or short in STEP_ROOT_CALLS
            or q.startswith(_STEP_ROOT_PREFIXES))


# Blocking-I/O entry points for DLT018's held-lock check. Values are short
# human labels for the message.
_BLOCKING_IO = {
    "urllib.request.urlopen": "urlopen",
    "http.client.HTTPConnection": "HTTPConnection",
    "http.client.HTTPSConnection": "HTTPSConnection",
    "socket.create_connection": "socket.create_connection",
    "requests.get": "requests.get", "requests.post": "requests.post",
    "requests.put": "requests.put", "requests.delete": "requests.delete",
    "requests.request": "requests.request",
    "subprocess.run": "subprocess.run",
    "subprocess.Popen": "subprocess.Popen",
    "subprocess.call": "subprocess.call",
    "subprocess.check_call": "subprocess.check_call",
    "subprocess.check_output": "subprocess.check_output",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}

# Draws from module-level RNG state: the stdlib's, numpy's, and torch's
# default generator (a torch draw with ``generator=`` is seeded state the
# checkpoint carries, and is exempt).
_HOST_RNG = frozenset({
    "random.random", "random.randint", "random.uniform", "random.gauss",
    "random.choice", "random.shuffle", "random.sample", "random.randrange",
})
_NP_RNG_CTORS = frozenset({
    "numpy.random.default_rng", "numpy.random.RandomState",
    "numpy.random.Generator", "numpy.random.SeedSequence",
    "numpy.random.PCG64", "numpy.random.Philox",
})
_TORCH_RNG = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.bernoulli", "torch.multinomial", "torch.normal", "torch.poisson",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
})
_TORCH_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})
_TENSOR_RNG_METHODS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
})

# Host syncs: readbacks, explicit waits, and the operations whose output
# size depends on the data (torch reads the size back before returning).
_SYNC_METHODS = {"item": ".item()", "tolist": ".tolist()", "cpu": ".cpu()",
                 "numpy": ".numpy()", "synchronize": ".synchronize()"}
_IMPLICIT_SYNCS = frozenset({"nonzero", "unique", "masked_select",
                             "bincount", "unique_consecutive"})
_SCALAR_CASTS = frozenset({"float", "int", "bool"})
# methods that return a tensor when called on one (a scalar cast of their
# result reads the device back); every name is a torch-only method or a
# reduction whose result is a 0-d tensor
_TENSOR_RESULT_METHODS = frozenset({
    "sum", "mean", "max", "min", "amax", "amin", "norm", "abs", "prod",
    "std", "var", "any", "all", "dot", "argmax", "argmin", "count_nonzero",
    "logsumexp", "median", "sqrt", "clamp", "double", "float", "to",
})
# methods no numpy array or Python container has: a call of one marks the
# function as doing torch device math
_TORCH_ONLY_METHODS = frozenset({
    "to", "contiguous", "cuda", "half", "bfloat16", "masked_fill",
    "masked_fill_", "index_select", "index_add_", "index_add", "scatter_add_",
    "scatter_", "unsqueeze", "permute", "expand", "expand_as", "topk",
    "gather", "copy_", "zero_", "add_", "mul_", "div_", "sub_",
    "addmm", "bmm", "clamp", "clamp_", "float", "long", "narrow",
    "new_zeros", "new_empty", "new_full", "detach", "data_ptr",
    "softmax", "log_softmax", "type_as",
})
_NOT_DEVICE_MATH = ("torch.device", "torch.Size", "torch.dtype", "torch.finfo",
                    "torch.iinfo", "torch.get_default_dtype", "torch.no_grad",
                    "torch.inference_mode", "torch.enable_grad",
                    "torch.is_tensor", "torch.is_grad_enabled",
                    "torch.cuda.is_available", "torch.cuda.device_count",
                    "torch.set_grad_enabled", "torch.Generator",
                    "torch.compile", "torch.func", "torch.vmap", "torch.jit")


def _has_kw(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


def is_device_math(q: str) -> bool:
    """A call target that computes on tensors: ``torch.*`` and
    ``torch.nn.functional.*``, less the constructors and queries that
    compute nothing."""
    return (q == "torch" or q.startswith("torch.")) and not any(
        q == n or q.startswith(n + ".") for n in _NOT_DEVICE_MATH)


def is_tensor_expr(node: ast.AST, resolve) -> bool:
    """An expression that evaluates to a tensor by its form: a torch call,
    or a method that returns a tensor when called on one."""
    if not isinstance(node, ast.Call):
        return False
    q = resolve(_dotted(node.func))
    if q.startswith("torch.") and is_device_math(q):
        return True
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in _TENSOR_RESULT_METHODS


def _int_repeats(node: ast.Call, attr: Optional[str]) -> bool:
    """``repeat_interleave``'s ``repeats`` is a Python int by its form (a
    literal, or read from ``.shape`` / ``.size()`` / ``len()``): the output
    size is known on the host and nothing is read back."""
    pos = 0 if attr is not None and not (
        isinstance(node.func, ast.Attribute) and
        _dotted(node.func.value) == "torch") else 1
    rep = next((k.value for k in node.keywords if k.arg == "repeats"),
               node.args[pos] if len(node.args) > pos else None)
    if rep is None:
        return False
    if isinstance(rep, ast.Constant) and isinstance(rep.value, int):
        return True
    return any(isinstance(n, ast.Attribute) and n.attr == "shape" or
               isinstance(n, ast.Call) and (_dotted(n.func) or "").rsplit(
                   ".", 1)[-1] in ("len", "size", "numel", "dim")
               for n in ast.walk(rep))


def sync_of(node: ast.Call, q: str, resolve) -> Optional[str]:
    """The host sync this call makes, as a label, or None. ``q`` is the
    alias-resolved dotted callee, ``resolve`` expands a dotted name."""
    func = node.func
    attr = func.attr if isinstance(func, ast.Attribute) else None
    if q == "torch.cuda.synchronize":
        return "torch.cuda.synchronize"
    if attr in _SYNC_METHODS and not (attr in ("item", "tolist")
                                      and (node.args or node.keywords)):
        return _SYNC_METHODS[attr]
    name = attr or q.rsplit(".", 1)[-1]
    if (attr is not None or q.startswith("torch.")) and name in _IMPLICIT_SYNCS \
            and not q.startswith("numpy."):
        return f"{name}() (data-dependent size)"
    if name == "repeat_interleave" and not _has_kw(node, "output_size") \
            and not q.startswith("numpy.") and not _int_repeats(node, attr):
        return "repeat_interleave() without output_size"
    if isinstance(func, ast.Name) and func.id in _SCALAR_CASTS and \
            len(node.args) == 1 and is_tensor_expr(node.args[0], resolve):
        return f"{func.id}(<tensor>)"
    return None


def rng_of(node: ast.Call, q: str) -> Optional[str]:
    """The global-RNG draw this call makes, as a label, or None."""
    if q in _HOST_RNG:
        return q
    if q.startswith("numpy.random.") and q not in _NP_RNG_CTORS:
        return q
    if q in _TORCH_SEEDING:
        return q
    if q in _TORCH_RNG and not _has_kw(node, "generator"):
        return f"{q} without generator="
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _TENSOR_RNG_METHODS and \
            not _has_kw(node, "generator") and not q.startswith("torch."):
        return f".{node.func.attr}() without generator="
    return None


_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
})


# ----------------------------------------------------------- summary data
@dataclasses.dataclass
class RawCall:
    """An unresolved call site: ``kind`` + ``parts`` describe the receiver.

    kinds: ``dotted`` (name or attribute chain rooted at a plain name),
    ``self`` (``self.method()``), ``selfattr`` (``self.<attr>.method()``),
    ``var`` (``<localvar>.method()``), ``super`` (``super().method()``).
    ``callbacks`` holds (kind, parts) refs for functions passed as args
    when the call makes them step roots (kind ``root``).
    """
    kind: str
    parts: Tuple[str, ...]
    lineno: int
    held: Tuple[str, ...] = ()
    callbacks: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()


@dataclasses.dataclass
class Hazard:
    kind: str       # rng | np | sync
    detail: str     # e.g. "torch.randperm without generator=", ".item()"
    lineno: int


@dataclasses.dataclass
class RawLockOp:
    token: str      # "self.<attr>" or a (possibly dotted) name as written
    lineno: int
    held: Tuple[str, ...]
    via: str        # "with" | "acquire"


@dataclasses.dataclass
class RawIo:
    what: str       # human label, e.g. "urlopen", "queue.get"
    lineno: int
    held: Tuple[str, ...]


@dataclasses.dataclass
class RawThread:
    lineno: int
    daemon: str                      # "true" | "false" | "absent" | "dynamic"
    target: Optional[Tuple[str, Tuple[str, ...]]]  # (kind, parts) ref
    assigned: Optional[str]          # "t" | "self._thread" | None
    direct: bool                     # True when assigned straight to a name


@dataclasses.dataclass
class FunctionFacts:
    qname: str
    name: str
    module: str
    path: str
    lineno: int
    cls: Optional[str] = None            # owning class qname for methods
    scopes: Tuple[str, ...] = ()         # enclosing function qnames, inner first
    calls: List[RawCall] = dataclasses.field(default_factory=list)
    hazards: List[Hazard] = dataclasses.field(default_factory=list)
    lock_ops: List[RawLockOp] = dataclasses.field(default_factory=list)
    io_calls: List[RawIo] = dataclasses.field(default_factory=list)
    thread_starts: List[RawThread] = dataclasses.field(default_factory=list)
    joins: Set[str] = dataclasses.field(default_factory=set)
    daemon_sets: Set[str] = dataclasses.field(default_factory=set)
    returns: Set[str] = dataclasses.field(default_factory=set)
    var_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    step_root: bool = False              # a root by its own definition
    uses_device: bool = False
    is_lambda: bool = False


@dataclasses.dataclass
class ClassFacts:
    qname: str
    name: str
    module: str
    path: str
    lineno: int
    bases: Tuple[str, ...] = ()          # raw dotted base names
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    methods: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ModuleSummary:
    path: str
    sha: str
    module: str
    is_pkg: bool
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionFacts] = dataclasses.field(
        default_factory=dict)
    classes: Dict[str, ClassFacts] = dataclasses.field(default_factory=dict)
    module_locks: Set[str] = dataclasses.field(default_factory=set)
    # waiver comments: line -> rules waived there (() = all rules);
    # file_waivers: rules waived file-wide. Kept here so repo-level rules
    # and the waiver audit never have to re-read the file.
    inline_waivers: Dict[int, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    file_waivers: Set[str] = dataclasses.field(default_factory=set)
    parse_error: Optional[Tuple[int, str]] = None


# ------------------------------------------------------------- name utils
def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_name_for(path: str) -> Tuple[str, bool]:
    """Dotted module name for a file, by walking up ``__init__.py`` chains.

    Loose files (no package) get ``<parentdir>.<stem>`` so tools/ and
    bench.py functions have unique qnames without colliding.
    """
    path = os.path.abspath(path)
    base = os.path.basename(path)
    is_pkg = base == "__init__.py"
    parts: List[str] = [] if is_pkg else [base[:-3]]
    d = os.path.dirname(path)
    depth = 0
    while os.path.isfile(os.path.join(d, "__init__.py")) and depth < 32:
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
        depth += 1
    if depth == 0 and not is_pkg:
        # loose file: qualify with the parent dir for uniqueness
        parent = os.path.basename(os.path.dirname(path))
        if parent:
            parts.insert(0, parent)
    elif is_pkg and not parts:
        parts = [os.path.basename(os.path.dirname(path))]
    return ".".join(parts), is_pkg


def _collect_aliases(tree: ast.Module, module: str,
                     is_pkg: bool) -> Dict[str, str]:
    """local name -> fully qualified target, resolving relative imports
    against the module's own package."""
    package = module if is_pkg else module.rsplit(".", 1)[0] \
        if "." in module else ""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg_parts = package.split(".") if package else []
                keep = len(pkg_parts) - (node.level - 1)
                anchor = ".".join(pkg_parts[:keep]) if keep > 0 else ""
                base = f"{anchor}.{base}".strip(".") if base else anchor
            if not base:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{base}.{a.name}"
    return out


_RULE_TOKEN = re.compile(r"DLT\d{3}")


def _collect_waivers(lines: Sequence[str]
                     ) -> Tuple[Dict[int, Tuple[str, ...]], Set[str]]:
    """Waiver comment locations, matching lint.py's ``_waived`` semantics:
    a ``lint: disable=DLT0XX`` line waives the named rules there; a line
    ending in bare ``disable`` waives everything on that line. Tokens must
    be real rule ids (``DLT`` + 3 digits) so prose mentioning the syntax
    (docstrings, this comment) is not mistaken for a waiver."""
    inline: Dict[int, Tuple[str, ...]] = {}
    filewide: Set[str] = set()
    for i, text in enumerate(lines, start=1):
        if "lint: disable-file=" in text:
            for part in text.split("lint: disable-file=")[1].split(","):
                part = part.strip()
                if part:
                    tok = part.split()[0].rstrip(")")
                    if _RULE_TOKEN.fullmatch(tok):
                        filewide.add(tok)
        elif "lint: disable=" in text:
            rules = tuple(sorted(set(
                _RULE_TOKEN.findall(text.split("lint: disable=", 1)[1]))))
            if rules:
                inline[i] = rules
        elif "lint: disable" in text and text.rstrip().endswith("disable"):
            inline[i] = ()  # () means "waive everything on this line"
    return inline, filewide


# ---------------------------------------------------------- the summarizer
class _Summarizer:
    """One pass over a module AST producing a :class:`ModuleSummary`."""

    def __init__(self, path: str, module: str, is_pkg: bool):
        self.path = path
        self.module = module
        self.is_pkg = is_pkg
        self.summary: Optional[ModuleSummary] = None
        self.aliases: Dict[str, str] = {}
        self.fns: Dict[str, FunctionFacts] = {}
        self.classes: Dict[str, ClassFacts] = {}
        self.module_locks: Set[str] = set()
        self._capture = 0   # depth of ``with torch.cuda.graph(...)`` blocks

    # -- small helpers -----------------------------------------------------
    def _resolve_alias(self, dotted: Optional[str]) -> str:
        if not dotted:
            return ""
        head, _, rest = dotted.partition(".")
        base = self.aliases.get(head, head)
        return f"{base}.{rest}" if rest else base

    def _ref_of(self, node: ast.AST
                ) -> Optional[Tuple[str, Tuple[str, ...]]]:
        """A (kind, parts) reference for a callable expression."""
        if isinstance(node, ast.Name):
            return ("dotted", (node.id,))
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return ("self", (node.attr,))
            d = _dotted(node)
            if d:
                return ("dotted", tuple(d.split(".")))
        if isinstance(node, ast.Lambda):
            return None  # handled by the caller (needs a qname)
        if isinstance(node, ast.Call):
            # functools.partial(f, ...) -> f
            q = self._resolve_alias(_dotted(node.func))
            if q.endswith("partial") and node.args:
                return self._ref_of(node.args[0])
        return None

    def _lock_token(self, node: ast.AST) -> Optional[str]:
        """``self._x_lock`` / module-level lock names as raw tokens."""
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return f"self.{node.attr}"
        d = _dotted(node)
        if d:
            return d
        return None

    # -- the walk ----------------------------------------------------------
    def run(self, tree: ast.Module, sha: str,
            lines: Sequence[str]) -> ModuleSummary:
        self.aliases = _collect_aliases(tree, self.module, self.is_pkg)
        inline, filewide = _collect_waivers(lines)
        mod_fn = FunctionFacts(
            qname=f"{self.module}.<module>", name="<module>",
            module=self.module, path=self.path, lineno=1)
        self.fns[mod_fn.qname] = mod_fn
        self._scan_stmts(tree.body, mod_fn, [], cls=None,
                         scopes=(), qprefix=self.module)
        self.summary = ModuleSummary(
            path=self.path, sha=sha, module=self.module, is_pkg=self.is_pkg,
            aliases=self.aliases, functions=self.fns, classes=self.classes,
            module_locks=self.module_locks, inline_waivers=inline,
            file_waivers=filewide)
        return self.summary

    def _visit_class(self, node: ast.ClassDef, qprefix: str,
                     scopes: Tuple[str, ...]):
        qname = f"{qprefix}.{node.name}"
        cf = ClassFacts(
            qname=qname, name=node.name, module=self.module, path=self.path,
            lineno=node.lineno,
            bases=tuple(b for b in (_dotted(x) for x in node.bases) if b))
        self.classes[qname] = cf
        # class body: methods + class-scope statements (run at import)
        holder = self.fns[f"{self.module}.<module>"]
        autograd = any(self._resolve_alias(b) in _AUTOGRAD_FUNCTION
                       for b in cf.bases)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cf.methods.add(stmt.name)
                self._visit_function(stmt, qprefix=qname, cls=cf,
                                     scopes=scopes)
                if autograd and stmt.name in ("forward", "backward"):
                    self.fns[f"{qname}.{stmt.name}"].step_root = True
            elif isinstance(stmt, ast.ClassDef):
                self._visit_class(stmt, qname, scopes)
            else:
                self._scan_stmts([stmt], holder, [], cls=cf, scopes=scopes,
                                 qprefix=qname)

    def _root_decorator(self, fn) -> bool:
        for dec in fn.decorator_list:
            d = dec.func if isinstance(dec, ast.Call) else dec
            if is_step_root_call(self._resolve_alias(_dotted(d)),
                                 _dotted(d) or ""):
                return True
            q = self._resolve_alias(_dotted(d))
            if isinstance(dec, ast.Call) and q.endswith("partial"):
                for a in dec.args:
                    if is_step_root_call(self._resolve_alias(_dotted(a)), ""):
                        return True
        return False

    def _counts_launches(self, fn) -> bool:
        """A kernel wrapper's launch function: it counts its launches in
        a module-level ``launches`` (``global launches``)."""
        if "perf/kernels/" not in self.path.replace(os.sep, "/"):
            return False
        return any(isinstance(n, ast.Global) and
                   any(name.endswith("launches") for name in n.names)
                   for n in ast.walk(fn))

    def _visit_function(self, node, qprefix: str,
                        cls: Optional[ClassFacts],
                        scopes: Tuple[str, ...]):
        qname = f"{qprefix}.{node.name}"
        ff = FunctionFacts(
            qname=qname, name=node.name, module=self.module, path=self.path,
            lineno=node.lineno, cls=cls.qname if cls else None,
            scopes=scopes, step_root=self._root_decorator(node)
            or self._counts_launches(node))
        self.fns[qname] = ff
        # decorators + defaults evaluate in the ENCLOSING scope
        holder = self.fns.get(scopes[0] if scopes
                              else f"{self.module}.<module>")
        if holder is not None:
            for expr in (node.decorator_list + node.args.defaults
                         + [d for d in node.args.kw_defaults if d]):
                self._scan_expr(expr, holder, [], cls, scopes, qprefix)
        self._scan_stmts(node.body, ff, [], cls=cls,
                         scopes=(qname,) + scopes, qprefix=qname)

    def _visit_lambda(self, node: ast.Lambda, owner: FunctionFacts,
                      cls, scopes, qprefix) -> FunctionFacts:
        qname = f"{owner.qname}.<lambda>L{node.lineno}"
        ff = FunctionFacts(
            qname=qname, name="<lambda>", module=self.module, path=self.path,
            lineno=node.lineno, cls=cls.qname if cls else None,
            scopes=(owner.qname,) + scopes, is_lambda=True)
        self.fns[qname] = ff
        self._scan_expr(node.body, ff, [], cls,
                        (owner.qname,) + scopes, qprefix)
        return ff

    # sequential statement scan: ``held`` is a mutable list so an
    # ``acquire()`` persists across the following sibling statements and a
    # ``release()`` (e.g. in a try/finally) removes it again.
    def _scan_stmts(self, stmts, fn: FunctionFacts, held: List[str],
                    cls, scopes, qprefix):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if fn.name == "<module>" and cls is None:
                    self._visit_function(node, qprefix=self.module, cls=None,
                                         scopes=())
                else:
                    self._visit_function(node, qprefix=fn.qname, cls=cls,
                                         scopes=(fn.qname,) + fn.scopes
                                         if fn.name != "<module>" else ())
                continue
            if isinstance(node, ast.ClassDef):
                self._visit_class(node, qprefix if fn.name == "<module>"
                                  else fn.qname, scopes)
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                capture = any(
                    isinstance(i.context_expr, ast.Call) and self._resolve_alias(
                        _dotted(i.context_expr.func)) == "torch.cuda.graph"
                    for i in node.items)
                for item in node.items:
                    self._scan_expr(item.context_expr, fn, held, cls,
                                    scopes, qprefix, skip_lock_expr=True)
                    tok = self._lock_token(item.context_expr)
                    if tok and self._looks_like_lock(tok, cls):
                        fn.lock_ops.append(RawLockOp(
                            tok, node.lineno, tuple(held + acquired),
                            "with"))
                        acquired.append(tok)
                held.extend(acquired)
                self._capture += capture
                self._scan_stmts(node.body, fn, held, cls, scopes, qprefix)
                self._capture -= capture
                for _ in acquired:
                    held.pop()
                continue
            if isinstance(node, ast.Try):
                self._scan_stmts(node.body, fn, held, cls, scopes, qprefix)
                for h in node.handlers:
                    self._scan_stmts(h.body, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.orelse, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.finalbody, fn, held, cls, scopes,
                                 qprefix)
                continue
            if isinstance(node, ast.If):
                self._scan_expr(node.test, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.body, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.orelse, fn, held, cls, scopes, qprefix)
                continue
            if isinstance(node, (ast.For, ast.AsyncFor)):
                self._scan_expr(node.iter, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.body, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.orelse, fn, held, cls, scopes, qprefix)
                continue
            if isinstance(node, ast.While):
                self._scan_expr(node.test, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.body, fn, held, cls, scopes, qprefix)
                self._scan_stmts(node.orelse, fn, held, cls, scopes, qprefix)
                continue
            # leaf statement: record assignments, then scan expressions
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._record_assign(node, fn, cls)
            if isinstance(node, ast.Return) and node.value is not None:
                d = _dotted(node.value)
                if d:
                    fn.returns.add(d)
            self._scan_expr(node, fn, held, cls, scopes, qprefix)

    def _looks_like_lock(self, token: str, cls) -> bool:
        if token.startswith("self."):
            attr = token[5:]
            if cls is not None and attr in cls.lock_attrs:
                return True
            return "lock" in attr.lower() or "cv" == attr.lstrip("_")
        head = token.split(".")[0]
        if token in self.module_locks or head in self.module_locks:
            return True
        # imported module-level lock (resolved against the table later)
        q = self._resolve_alias(token)
        last = q.rsplit(".", 1)[-1].lower()
        return "lock" in last

    def _record_assign(self, node, fn: FunctionFacts, cls):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        value = node.value
        if value is None:
            return
        # thread daemon flag set post-hoc: t.daemon = True
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "daemon" and \
                    isinstance(value, ast.Constant) and value.value is True:
                recv = _dotted(t.value)
                if recv:
                    fn.daemon_sets.add(recv)
        if not isinstance(value, ast.Call):
            return
        q = self._resolve_alias(_dotted(value.func))
        for t in targets:
            if isinstance(t, ast.Name):
                if q in _LOCK_CTORS:
                    if fn.name == "<module>" and cls is None:
                        self.module_locks.add(t.id)
                elif q:
                    fn.var_types[t.id] = q
            elif isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and cls is not None:
                if q in _LOCK_CTORS:
                    cls.lock_attrs.add(t.attr)
                elif q:
                    cls.attr_types[t.attr] = q

    # expression scan: record calls/hazards/io/threads; handle explicit
    # acquire/release; descend into lambdas as separate functions.
    def _scan_expr(self, node, fn: FunctionFacts, held: List[str],
                   cls, scopes, qprefix, skip_lock_expr: bool = False):
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                self._visit_lambda(n, fn, cls, scopes, qprefix)
                continue
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue  # handled structurally
            if isinstance(n, ast.Call):
                self._record_call(n, fn, held, cls, scopes, qprefix)
                if is_device_math(self._resolve_alias(_dotted(n.func))) or (
                        isinstance(n.func, ast.Attribute)
                        and n.func.attr in _TORCH_ONLY_METHODS):
                    fn.uses_device = True
            stack.extend(ast.iter_child_nodes(n))

    def _record_call(self, node: ast.Call, fn: FunctionFacts,
                     held: List[str], cls, scopes, qprefix):
        func = node.func
        q = self._resolve_alias(_dotted(func))
        attr = func.attr if isinstance(func, ast.Attribute) else None

        # explicit lock acquire/release
        if attr in ("acquire", "release"):
            tok = self._lock_token(func.value)
            if tok and self._looks_like_lock(tok, cls):
                if attr == "acquire":
                    fn.lock_ops.append(RawLockOp(
                        tok, node.lineno, tuple(held), "acquire"))
                    held.append(tok)
                elif tok in held:
                    held.remove(tok)
                return

        # thread lifecycle observations
        if attr == "join":
            recv = _dotted(func.value)
            if recv:
                fn.joins.add(recv)
        if attr == "setDaemon" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value is True:
            recv = _dotted(func.value)
            if recv:
                fn.daemon_sets.add(recv)

        # hazards (host work, for the DLT017 closure)
        sync = sync_of(node, q, self._resolve_alias)
        rng = rng_of(node, q)
        if sync:
            fn.hazards.append(Hazard("sync", sync, node.lineno))
        elif rng:
            fn.hazards.append(Hazard("rng", rng, node.lineno))
        elif q == "numpy" or q.startswith("numpy."):
            fn.hazards.append(Hazard("np", q, node.lineno))

        # blocking I/O (for DLT018's held-lock check)
        if q in _BLOCKING_IO:
            fn.io_calls.append(RawIo(_BLOCKING_IO[q], node.lineno,
                                     tuple(held)))
        elif attr == "synchronize":
            fn.io_calls.append(RawIo("Event.synchronize", node.lineno,
                                     tuple(held)))
        elif attr in ("get", "put") and isinstance(func, ast.Attribute):
            recv = (_dotted(func.value) or "").rsplit(".", 1)[-1].lower()
            if "queue" in recv or recv in ("q", "_q") or \
                    recv.endswith("_q"):
                fn.io_calls.append(RawIo(f"queue.{attr}", node.lineno,
                                         tuple(held)))

        # thread starts
        if q == "threading.Thread":
            daemon = "absent"
            target: Optional[Tuple[str, Tuple[str, ...]]] = None
            for kw in node.keywords:
                if kw.arg == "daemon":
                    daemon = ("true" if isinstance(kw.value, ast.Constant)
                              and kw.value.value is True else
                              "false" if isinstance(kw.value, ast.Constant)
                              and kw.value.value is False else "dynamic")
                elif kw.arg == "target":
                    target = self._ref_of(kw.value)
            assigned, direct = self._assign_target_of(node)
            fn.thread_starts.append(RawThread(
                node.lineno, daemon, target, assigned, direct))

        # callables that become step roots: torch.compile / torch.func.* /
        # make_graphed_callables targets, CompileWatch.wrap(fn, key),
        # _watched(key, fn)
        short = _dotted(func) or ""
        root_args: List[ast.AST] = []
        if is_step_root_call(q, short):
            root_args = list(node.args) + [k.value for k in node.keywords]
        elif attr == "wrap" and (_dotted(func.value) or "").rsplit(
                ".", 1)[-1].lower().endswith("watch"):
            root_args = node.args[:1] + [k.value for k in node.keywords
                                         if k.arg == "fn"]
        elif attr == "_watched":
            root_args = node.args[1:2] + [k.value for k in node.keywords
                                          if k.arg == "fn"]
        if root_args:
            cbs = []
            for arg in root_args:
                if isinstance(arg, ast.Lambda):
                    lam = self._visit_lambda(arg, fn, cls, scopes, qprefix)
                    cbs.append(("dotted", (lam.qname,)))
                    continue
                ref = self._ref_of(arg)
                if ref:
                    cbs.append(ref)
            if cbs:
                fn.calls.append(RawCall("root", (q or short,), node.lineno,
                                        tuple(held), tuple(cbs)))
            if is_step_root_call(q, short):
                return
        if self._capture:
            ref = self._ref_of(func)
            if ref:
                fn.calls.append(RawCall("root", ("torch.cuda.graph",),
                                        node.lineno, tuple(held), (ref,)))

        # the ordinary call-edge record
        if isinstance(func, ast.Name):
            fn.calls.append(RawCall("dotted", (func.id,), node.lineno,
                                    tuple(held)))
        elif isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id == "self":
                fn.calls.append(RawCall("self", (func.attr,), node.lineno,
                                        tuple(held)))
            elif isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                fn.calls.append(RawCall("selfattr", (base.attr, func.attr),
                                        node.lineno, tuple(held)))
            elif isinstance(base, ast.Call) and \
                    isinstance(base.func, ast.Name) and \
                    base.func.id == "super":
                fn.calls.append(RawCall("super", (func.attr,), node.lineno,
                                        tuple(held)))
            elif isinstance(base, ast.Name):
                fn.calls.append(RawCall("var", (base.id, func.attr),
                                        node.lineno, tuple(held)))
            else:
                d = _dotted(func)
                if d:
                    fn.calls.append(RawCall("dotted", tuple(d.split(".")),
                                            node.lineno, tuple(held)))

    def _assign_target_of(self, call: ast.Call
                          ) -> Tuple[Optional[str], bool]:
        """(receiver, direct) for ``x = Thread(...)`` — resolved by the
        parent map built lazily per statement scan."""
        parent = getattr(call, "_dlt_parent", None)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            t = parent.targets[0]
            d = _dotted(t)
            if d:
                return d, True
        return None, False


def _attach_parents(tree: ast.AST):
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._dlt_parent = node  # type: ignore[attr-defined]


# ------------------------------------------------------------------ cache
_SUMMARY_CACHE: Dict[str, Tuple[str, ModuleSummary]] = {}
_GRAPH_CACHE: Dict[frozenset, "CallGraph"] = {}


def clear_cache():
    _SUMMARY_CACHE.clear()
    _GRAPH_CACHE.clear()


def summarize_source(path: str, src: str) -> ModuleSummary:
    sha = hashlib.sha1(src.encode("utf-8", "replace")).hexdigest()
    module, is_pkg = module_name_for(path)
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        inline, filewide = _collect_waivers(lines)
        return ModuleSummary(path=os.path.abspath(path), sha=sha,
                             module=module, is_pkg=is_pkg,
                             inline_waivers=inline, file_waivers=filewide,
                             parse_error=(e.lineno or 0, e.msg or "syntax"))
    _attach_parents(tree)
    return _Summarizer(os.path.abspath(path), module, is_pkg).run(
        tree, sha, lines)


def summarize_file(path: str) -> ModuleSummary:
    apath = os.path.abspath(path)
    with open(apath, encoding="utf-8") as f:
        src = f.read()
    sha = hashlib.sha1(src.encode("utf-8", "replace")).hexdigest()
    cached = _SUMMARY_CACHE.get(apath)
    if cached is not None and cached[0] == sha:
        return cached[1]
    summary = summarize_source(apath, src)
    _SUMMARY_CACHE[apath] = (sha, summary)
    return summary


def discover_files(paths: Iterable[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for f in sorted(names):
                    if f.endswith(".py"):
                        files.append(os.path.join(root, f))
        elif p.endswith(".py") and os.path.isfile(p):
            files.append(p)
    return files


# -------------------------------------------------------------- the graph
@dataclasses.dataclass
class Edge:
    callee: str
    lineno: int
    held: Tuple[str, ...]   # resolved lock ids held at the call site


@dataclasses.dataclass
class LockAcq:
    lock: str
    lineno: int
    held: Tuple[str, ...]
    via: str


class CallGraph:
    """Resolved whole-repo call graph over a set of module summaries."""

    def __init__(self, summaries: Sequence[ModuleSummary]):
        self.summaries = list(summaries)
        self.modules: Dict[str, ModuleSummary] = {
            s.module: s for s in summaries}
        self.functions: Dict[str, FunctionFacts] = {}
        self.classes: Dict[str, ClassFacts] = {}
        for s in summaries:
            self.functions.update(s.functions)
            self.classes.update(s.classes)
        self.edges: Dict[str, List[Edge]] = {}
        self.step_roots: Set[str] = set()
        self.thread_targets: Set[str] = set()
        self.lock_acqs: Dict[str, List[LockAcq]] = {}
        self.io_held: Dict[str, List[Tuple[str, int, Tuple[str, ...]]]] = {}
        self._resolved_bases: Dict[str, Tuple[str, ...]] = {}
        self._acq_closure: Dict[str, Set[str]] = {}
        self._io_closure: Dict[str, Set[str]] = {}
        self._resolve()

    # -- symbol resolution -------------------------------------------------
    def _resolve_qualified(self, q: str, depth: int = 0
                           ) -> Optional[Tuple[str, str]]:
        if not q or depth > 6:
            return None
        if q in self.functions:
            return ("func", q)
        if q in self.classes:
            return ("class", q)
        parts = q.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            summ = self.modules.get(mod)
            if summ is None:
                continue
            rest = parts[i:]
            cand = f"{mod}.{rest[0]}"
            if len(rest) == 1:
                if cand in self.functions:
                    return ("func", cand)
                if cand in self.classes:
                    return ("class", cand)
            elif cand in self.classes and len(rest) == 2:
                m = self.lookup_method(cand, rest[1])
                if m:
                    return ("func", m)
            target = summ.aliases.get(rest[0])
            if target:
                return self._resolve_qualified(
                    ".".join([target] + rest[1:]), depth + 1)
            return None
        return None

    def resolved_bases(self, cls_qname: str) -> Tuple[str, ...]:
        if cls_qname in self._resolved_bases:
            return self._resolved_bases[cls_qname]
        self._resolved_bases[cls_qname] = ()  # cycle guard
        cf = self.classes.get(cls_qname)
        out: List[str] = []
        if cf is not None:
            summ = self.modules.get(cf.module)
            for raw in cf.bases:
                # a base defined in the same module, by its bare name (the
                # JAX module resolves only imported bases)
                local = f"{cf.module}.{raw}"
                q = local if local in self.classes else self._expand(raw, summ)
                r = self._resolve_qualified(q)
                if r and r[0] == "class":
                    out.append(r[1])
        self._resolved_bases[cls_qname] = tuple(out)
        return self._resolved_bases[cls_qname]

    def lookup_method(self, cls_qname: str, name: str,
                      _depth: int = 0) -> Optional[str]:
        if _depth > 8:
            return None
        q = f"{cls_qname}.{name}"
        if q in self.functions:
            return q
        for b in self.resolved_bases(cls_qname):
            r = self.lookup_method(b, name, _depth + 1)
            if r:
                return r
        return None

    def overrides(self, cls_qname: str, name: str) -> List[str]:
        """``name`` as defined by every class that derives from
        ``cls_qname`` (directly or not)."""
        out = []
        for q in self.classes:
            if q == cls_qname or f"{q}.{name}" not in self.functions:
                continue
            seen, todo = set(), [q]
            while todo:
                c = todo.pop()
                if c in seen:
                    continue
                seen.add(c)
                if cls_qname in self.resolved_bases(c):
                    out.append(f"{q}.{name}")
                    break
                todo.extend(self.resolved_bases(c))
        return sorted(out)

    def class_attr(self, cls_qname: str, attr: str, field: str,
                   _depth: int = 0):
        """attr_types / lock_attrs lookup walking the resolved bases."""
        if _depth > 8:
            return None
        cf = self.classes.get(cls_qname)
        if cf is None:
            return None
        store = getattr(cf, field)
        if field == "lock_attrs":
            if attr in store:
                return cls_qname
        elif attr in store:
            return store[attr], cf.module
        for b in self.resolved_bases(cls_qname):
            r = self.class_attr(b, attr, field, _depth + 1)
            if r:
                return r
        return None

    @staticmethod
    def _expand(dotted: str, summ: Optional[ModuleSummary]) -> str:
        if not summ:
            return dotted
        head, _, rest = dotted.partition(".")
        base = summ.aliases.get(head, head)
        return f"{base}.{rest}" if rest else base

    def _resolve_ref(self, kind: str, parts: Tuple[str, ...],
                     fn: FunctionFacts) -> Optional[str]:
        """Resolve a (kind, parts) reference to a function qname."""
        summ = self.modules.get(fn.module)
        if kind == "dotted":
            name = parts[0]
            if len(parts) == 1:
                # scope chain: nested defs, then module scope, then aliases
                for scope in fn.scopes:
                    cand = f"{scope}.{name}"
                    if cand in self.functions:
                        return cand
                    if cand in self.classes:
                        return self.lookup_method(cand, "__init__")
                cand = f"{fn.module}.{name}"
                if cand in self.functions:
                    return cand
                if cand in self.classes:
                    return self.lookup_method(cand, "__init__")
                if name in self.functions:  # already a qname (lambdas)
                    return name
            q = self._expand(".".join(parts), summ)
            r = self._resolve_qualified(q)
            if r is None:
                return None
            if r[0] == "class":
                return self.lookup_method(r[1], "__init__")
            return r[1]
        if kind == "self" and fn.cls:
            return self.lookup_method(fn.cls, parts[0])
        if kind == "super" and fn.cls:
            for b in self.resolved_bases(fn.cls):
                r = self.lookup_method(b, parts[0])
                if r:
                    return r
            return None
        if kind == "selfattr" and fn.cls:
            at = self.class_attr(fn.cls, parts[0], "attr_types")
            if at:
                raw, mod = at
                r = self._resolve_qualified(raw)
                if r and r[0] == "class":
                    return self.lookup_method(r[1], parts[1])
            return None
        if kind == "var":
            raw = fn.var_types.get(parts[0])
            if raw:
                r = self._resolve_qualified(raw)
                if r and r[0] == "class":
                    return self.lookup_method(r[1], parts[1])
                return None  # typed receiver, but not a resolvable class
            # receiver is not a known local instance: try the whole thing
            # as a module/alias dotted path (``stats.standardize(...)``
            # after ``from . import stats``, ``mod.Class(...)``, ...)
            q = self._expand(".".join(parts), summ)
            r = self._resolve_qualified(q)
            if r is None:
                return None
            if r[0] == "class":
                return self.lookup_method(r[1], "__init__")
            return r[1]
        return None

    def _resolve_lock(self, token: str, fn: FunctionFacts) -> Optional[str]:
        """Raw lock token -> stable lock identity, or None if unknown."""
        if token.startswith("self."):
            attr = token[5:]
            if fn.cls:
                owner = self.class_attr(fn.cls, attr, "lock_attrs")
                if owner:
                    return f"{owner}.{attr}"
                if "lock" in attr.lower():
                    return f"{fn.cls}.{attr}"
            return None
        summ = self.modules.get(fn.module)
        head = token.split(".")[0]
        if summ and head in summ.module_locks and "." not in token:
            return f"{fn.module}.{token}"
        q = self._expand(token, summ) if summ else token
        parts = q.split(".")
        if len(parts) >= 2:
            mod, var = ".".join(parts[:-1]), parts[-1]
            m = self.modules.get(mod)
            if m and var in m.module_locks:
                return f"{mod}.{var}"
        return None

    # -- build -------------------------------------------------------------
    def _resolve(self):
        for fn in list(self.functions.values()):
            edges: List[Edge] = []
            held_cache: Dict[Tuple[str, ...], Tuple[str, ...]] = {}

            def rheld(raw: Tuple[str, ...]) -> Tuple[str, ...]:
                if raw not in held_cache:
                    held_cache[raw] = tuple(
                        r for r in (self._resolve_lock(t, fn) for t in raw)
                        if r)
                return held_cache[raw]

            for call in fn.calls:
                if call.kind == "root":
                    for ckind, cparts in call.callbacks:
                        target = self._resolve_ref(ckind, cparts, fn)
                        if target:
                            self.step_roots.add(target)
                            edges.append(Edge(target, call.lineno,
                                              rheld(call.held)))
                        if ckind == "self" and fn.cls:
                            # self.m dispatches to a subclass's override
                            self.step_roots.update(
                                self.overrides(fn.cls, cparts[0]))
                    continue
                target = self._resolve_ref(call.kind, call.parts, fn)
                if target and target != fn.qname:
                    edges.append(Edge(target, call.lineno, rheld(call.held)))
            for th in fn.thread_starts:
                if th.target:
                    t = self._resolve_ref(th.target[0], th.target[1], fn)
                    if t:
                        self.thread_targets.add(t)
            self.edges[fn.qname] = edges
            self.lock_acqs[fn.qname] = [
                LockAcq(lk, op.lineno, rheld(op.held), op.via)
                for op in fn.lock_ops
                for lk in [self._resolve_lock(op.token, fn)] if lk]
            self.io_held[fn.qname] = [
                (io.what, io.lineno, rheld(io.held)) for io in fn.io_calls]
            if fn.step_root:
                self.step_roots.add(fn.qname)

    # -- queries -----------------------------------------------------------
    def entries(self) -> List[str]:
        return sorted(self.step_roots)

    def reachable_from_entries(self) -> Dict[str, Tuple[str, ...]]:
        """{qname: (root, ..., qname)} for every function reachable from a
        step root, each with its shortest chain (roots in sorted order
        break ties)."""
        best: Dict[str, Tuple[str, ...]] = {}
        for entry in self.entries():
            for qname, chain in self.reachable_from(entry).items():
                if qname not in best or len(chain) < len(best[qname]):
                    best[qname] = chain
        return best

    def reachable_from(self, entry: str
                       ) -> Dict[str, Tuple[str, ...]]:
        """{reached qname: (entry, ..., reached)} chains via BFS."""
        chains: Dict[str, Tuple[str, ...]] = {entry: (entry,)}
        frontier = [entry]
        while frontier:
            nxt: List[str] = []
            for f in frontier:
                for e in self.edges.get(f, ()):
                    if e.callee not in chains:
                        chains[e.callee] = chains[f] + (e.callee,)
                        nxt.append(e.callee)
            frontier = nxt
        return chains

    def acq_closure(self, qname: str) -> Set[str]:
        """All locks ``qname`` may acquire, directly or via callees."""
        if qname in self._acq_closure:
            return self._acq_closure[qname]
        self._acq_closure[qname] = set()  # cycle guard
        out = {a.lock for a in self.lock_acqs.get(qname, ())}
        for e in self.edges.get(qname, ()):
            out |= self.acq_closure(e.callee)
        self._acq_closure[qname] = out
        return out

    def io_closure(self, qname: str) -> Set[str]:
        """Blocking-I/O labels reachable from ``qname`` (incl. its own)."""
        if qname in self._io_closure:
            return self._io_closure[qname]
        self._io_closure[qname] = set()
        out = {w for w, _, _ in self.io_held.get(qname, ())}
        for e in self.edges.get(qname, ()):
            out |= self.io_closure(e.callee)
        self._io_closure[qname] = out
        return out

    def find_path(self, src: str, dst: str,
                  limit: int = 100000) -> Optional[Tuple[str, ...]]:
        """Shortest call chain src -> ... -> dst, or None."""
        if src == dst:
            return (src,)
        chains = {src: (src,)}
        frontier = [src]
        seen = 0
        while frontier and seen < limit:
            nxt: List[str] = []
            for f in frontier:
                for e in self.edges.get(f, ()):
                    if e.callee in chains:
                        continue
                    chains[e.callee] = chains[f] + (e.callee,)
                    if e.callee == dst:
                        return chains[e.callee]
                    nxt.append(e.callee)
                    seen += 1
            frontier = nxt
        return None


def build_graph(paths: Iterable[str]) -> CallGraph:
    files = discover_files(paths)
    summaries = [summarize_file(p) for p in files]
    key = frozenset((s.path, s.sha) for s in summaries)
    g = _GRAPH_CACHE.get(key)
    if g is None:
        g = CallGraph(summaries)
        _GRAPH_CACHE.clear()  # one graph per working set is enough
        _GRAPH_CACHE[key] = g
    return g
