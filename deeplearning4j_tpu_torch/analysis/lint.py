"""The port's linter: AST rules for the hazards of eager PyTorch on a card
(counterpart of ``deeplearning4j_tpu/analysis/lint.py``, whose rule codes,
waiver syntax and entry points it keeps).

Waive a finding on its line with ``# lint: disable=DLT0XX (reason)``, or
for a whole file with ``# lint: disable-file=DLT0XX``. The linter reads
source files as text and ASTs and never imports the code it lints.

Each rule names the JAX package's hazard and the port's counterpart. The
**host rules** (DLT004, 006, 007, 008, 011, 016, 018, 019, 021) carry
over with the same logic and messages over the port's paths. The **device
rules** guard what the JAX package guarded with ``jnp`` / ``lax`` /
``jax.jit``, which never occur in the port; their port counterparts guard
the port's own hazards: ``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``float(<tensor>)``, torch's implicit syncs, global RNG
draws, and a wrapper that quietly falls back to the plain version.

"Device math" below means a ``torch.*`` / ``torch.nn.functional.*`` call
(constructors and queries such as ``torch.device`` excluded) or a
torch-only tensor method (``.to``, ``.view``, ``.index_add_``, ...).
"Host work" means a host sync (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``.synchronize()``, ``torch.cuda.synchronize``,
``float/int/bool`` of a tensor expression, and the implicit syncs of
``nonzero``, ``torch.unique``, ``masked_select``, ``bincount`` and
``repeat_interleave`` without ``output_size``) or a ``np.*`` call.
"Step roots" are defined in ``analysis/callgraph.py``: callables passed
to ``CompileWatch.wrap`` / ``_watched``, ``forward`` / ``backward`` of a
``torch.autograd.Function``, the kernel wrappers' launch functions, and
targets of ``torch.compile`` / ``torch.func.*`` / CUDA graphs.

- **DLT001 import-time-device-work.** JAX: ``jnp`` / ``lax`` computation
  at import time initialises the backend early. Port: a torch tensor
  computation or any ``torch.cuda.*`` call at module or class scope, in a
  decorator or in a default argument. It initialises CUDA at import and
  fixes a device before any ``device=`` is read. Dtypes, ``torch.device``,
  ``torch.Size``, ``torch.Generator`` and grad-mode decorators are not
  computation.

- **DLT002 global-rng-in-step.** JAX: wall clocks and host RNG inside
  jit-traced code freeze into the compiled program. Port: a global RNG
  draw inside a step root: ``random.*`` and ``np.random.*`` module calls
  (seeded constructors such as ``default_rng`` exempt), and
  ``torch.rand/randn/randint/randperm/bernoulli/multinomial/normal`` or
  ``Tensor.uniform_/normal_/bernoulli_`` without ``generator=``, and
  ``torch.manual_seed``. Such a draw escapes the generator that
  ``torchGeneratorState.npz`` checkpoints, so a resume is no longer exact.
  Clocks have no port counterpart: eager torch runs the step body every
  call, so a clock read there reads the clock each step; they are not
  flagged.

- **DLT003 bench-timing-sync.** JAX: a benchmark stopwatch without
  ``block_until_ready`` measures dispatch. Port: the same scope
  (``bench*``, ``*perf*``, ``*profile*``, ``tools/``, plus
  ``chip_smoke.py``): a function that reads the clock twice must also
  sync: ``torch.cuda.synchronize``, ``Event.synchronize`` /
  ``elapsed_time``, ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``
  or ``float(...)``. CUDA launches return before the card finishes.

- **DLT004 lock-order** (host rule, JAX and port alike): two locks of one
  class taken in opposite orders (``with`` blocks and explicit
  ``acquire()`` / ``release()``), per class.

- **DLT005 serving-bn-fold.** JAX and port alike: a file that builds a
  model with ``BatchNormalization`` and serves it through
  ``ParallelInference`` without ``fold_bn`` (the port's
  ``ParallelInference(fold_bn=True)`` / ``perf.fusion.fold_bn``).

- **DLT006 swallowed-storage-error** (host rule, JAX and port alike): a
  broad ``except`` in ``checkpoint/`` / ``storage/`` that neither
  re-raises, logs nor stashes the error.

- **DLT007 metric-registration** (host rule, JAX and port alike): a
  registry instrument without ``unit=`` and ``help=``, or a new bare
  counter dict (``counters`` / ``*_counters``).

- **DLT008 unbounded-queue** (host rule, JAX and port alike):
  ``queue.Queue()`` without a bound in serving / parallel / datasets /
  storage / checkpoint / retrieval paths.

- **DLT009 host-work-in-compression-path.** JAX: host work in a
  compression function that also uses ``jnp`` forces a sync per step.
  Port: the same name scope (``*compress*`` functions, methods of
  ``*Compression*`` classes) with torch device math; host work flagged.

- **DLT010 float-cast-in-quant-path.** JAX: ``.astype(float32/float64)``
  in the int8 path. Port: ``.float()``, ``.double()``,
  ``.to(torch.float32/float64)`` and ``.type(...)`` to a float type in
  ``*Quantized*`` classes and in ``*quant*`` functions that do device
  math; ``torch.float64`` / ``torch.double`` anywhere in that scope, and
  ``np.float64(...)``. Int casts and scalar wraps are exempt.

- **DLT011 unseeded-global-rng-in-data-path** (host rule, widened): in
  ``datasets/`` / ``parallel/``, the JAX list of module-level ``random.*``
  / ``np.random.*`` draws, and in the port also ``torch.randperm`` /
  ``torch.rand*`` without ``generator=`` and ``torch.manual_seed``.

- **DLT012 autotune-work-in-hot-path.** JAX: ``.lower().compile()`` and
  ``cost_analysis`` / ``memory_analysis`` in serving / training hot paths.
  Port: autotune-time work in the same files (``serving/``, ``parallel/``,
  ``nn/multilayer.py``, ``nn/graph.py``): meta-device estimates
  (``device="meta"``, ``FlopCounterMode``, ``perf.autotune`` estimates,
  ``fusion.training_activation_bytes``), ``torch.cuda.memory_snapshot``,
  and kernel builds (``_build.build``, ``nvcc`` in a subprocess). XLA
  compilation has no counterpart.

- **DLT013 host-work-in-retrieval-hot-path.** JAX: host work in a
  ``retrieval/`` scoring function that also uses ``jnp``. Port: the same
  scope (step roots, or names with ``score`` / ``topk`` / ``probe``) with
  torch device math; host work flagged.

- **DLT014 host-work-in-pack-path.** JAX: host unpacking in
  ``quant/`` / ``retrieval/`` functions named ``pack`` / ``unpack`` /
  ``nibble`` / ``adc`` / ``pq`` that also use ``jnp``. Port: the same
  scope with torch device math; host work flagged.

- **DLT015 host-work-in-kernel-launch.** JAX: host work and Python
  control flow in a Pallas kernel body (``perf/pallas/``). The kernel
  body itself has no port counterpart (it is CUDA C++ in ``csrc/``). Port:
  in the wrappers' launch functions in ``perf/kernels/`` (those that count
  their launches), (a) host work between the wrapper's entry and its
  ctypes launch, and (b) a ``try`` around a build or a launch whose
  handler returns the plain version: ROADMAP's no-fallback rule, which
  would otherwise pass every CPU test and hide on the card.

- **DLT016 blocking-io-without-timeout** (host rule, JAX and port alike):
  outbound socket / HTTP calls without a timeout in ``fleet/`` /
  ``serving/``.

- **DLT020 per-token-host-transfer.** JAX: a host transfer inside the
  loop of a decode / sampling function that uses ``jnp``. Port: the same
  scope (``serving/``, ``nn/``; names with decode / sample / generate /
  stream / token) with torch device math; host work inside a loop body
  flagged.

- **DLT021 unbounded-lake-io** (host rule, JAX and port alike): unbounded
  ``.read()`` / ``.recv()`` / ``.readline()`` and timeout-less connections
  in ``checkpoint/cloud``, ``checkpoint/emulator`` and ``tools/lake``.

The interprocedural rules run over the call graph of the whole working
set (``analysis/callgraph.py``), only from ``lint_paths`` and the
``python -m deeplearning4j_tpu_torch.tools.run_lint`` CLI:

- **DLT017 host-work-reachable-from-step.** JAX: host work reachable
  from a jit entry. Port: host syncs in a step root or reachable from
  one, and global RNG draws reachable one call hop or more (the root's
  own draws are DLT002's); ``np.*`` only in functions that also do torch
  device math. The message carries the chain.

- **DLT018 cross-module-lock-analysis** (host rule, JAX and port alike):
  lock pairs taken in opposite orders across classes and modules, and
  blocking calls under a held lock in serving / fleet / checkpoint /
  parallel paths. Its blocking table puts ``torch.cuda.synchronize`` /
  ``Event.synchronize`` where the JAX package's ``block_until_ready``
  stands.

- **DLT019 thread-lifecycle** (host rule, JAX and port alike): a
  ``threading.Thread`` started without ``daemon=True`` and without a
  recorded join.

Adding a rule: write ``_rule_xxx(tree, src, path) -> List[LintViolation]``
and register it in ``_RULES`` (``_REPO_RULES`` for one that takes the
``CallGraph``); ``tests/test_torch_lint.py`` holds its fixtures.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis import callgraph as _cg

__all__ = ["LintViolation", "StaleWaiver", "lint_file", "lint_paths",
           "raw_findings", "audit_waivers", "clear_caches", "DEFAULT_TARGETS"]


@dataclasses.dataclass(frozen=True)
class LintViolation:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


# --------------------------------------------------------------- utilities
_dotted = _cg._dotted


def _walk(node: ast.AST) -> List[ast.AST]:
    """``ast.walk(node)`` as a list, kept on the node: the rules walk the
    same trees many times."""
    nodes = getattr(node, "_walk_nodes", None)
    if nodes is None:
        nodes = node._walk_nodes = list(ast.walk(node))
    return nodes


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """local name -> fully qualified module path, for every import (kept
    on the tree)."""
    cached = getattr(tree, "_aliases", None)
    if cached is not None:
        return cached
    out: Dict[str, str] = {}
    tree._aliases = out
    for node in _walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _resolve(dotted: Optional[str], aliases: Dict[str, str]) -> str:
    """Expand the leading alias of a dotted path to its import target."""
    if not dotted:
        return ""
    head, _, rest = dotted.partition(".")
    base = aliases.get(head, head)
    return f"{base}.{rest}" if rest else base


def _functions(tree) -> Iterable[ast.AST]:
    for node in _walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _uses_device_math(fn, aliases) -> bool:
    cached = getattr(fn, "_device_math", None)
    if cached is None:
        cached = fn._device_math = any(
            isinstance(node, ast.Call) and (
                _cg.is_device_math(_resolve(_dotted(node.func), aliases))
                or isinstance(node.func, ast.Attribute)
                and node.func.attr in _cg._TORCH_ONLY_METHODS)
            for node in _walk(fn))
    return cached


def _host_work(node: ast.Call, aliases) -> Optional[str]:
    """The host work a call does (a sync or a ``np.*`` call), as the
    message's label, or None."""
    q = _resolve(_dotted(node.func), aliases)
    sync = _cg.sync_of(node, q, lambda d: _resolve(d, aliases))
    if sync:
        return f"'{sync}' (host sync)"
    if q == "numpy" or q.startswith("numpy."):
        return f"'{q}(...)' (host numpy)"
    return None


def _step_root_args(tree, aliases) -> Tuple[Set[str], List[ast.Lambda]]:
    """What a file hands to a step-root call (torch.compile / torch.func.*
    targets, ``<watch>.wrap(fn, key)``, ``_watched(key, fn)``): the names
    of the functions, and the lambdas passed inline."""
    names: Set[str] = set()
    lambdas: List[ast.Lambda] = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        q = _resolve(_dotted(func), aliases)
        args: List[ast.AST] = []
        if _cg.is_step_root_call(q, _dotted(func) or ""):
            args = list(node.args) + [k.value for k in node.keywords]
        elif isinstance(func, ast.Attribute) and func.attr == "wrap" and \
                (_dotted(func.value) or "").rsplit(".", 1)[-1].lower() \
                .endswith("watch"):
            args = node.args[:1]
        elif isinstance(func, ast.Attribute) and func.attr == "_watched":
            args = node.args[1:2]
        for a in args:
            if isinstance(a, ast.Name):
                names.add(a.id)
            elif isinstance(a, ast.Attribute):
                names.add(a.attr)
            elif isinstance(a, ast.Lambda):
                lambdas.append(a)
    return names, lambdas


def _root_decorated(fn, aliases) -> bool:
    """Decorated by a step-root call, directly or through
    ``functools.partial(torch.compile, ...)``."""
    for d in fn.decorator_list:
        q = _resolve(_dotted(d.func if isinstance(d, ast.Call) else d), aliases)
        if _cg.is_step_root_call(q, ""):
            return True
        if isinstance(d, ast.Call) and q.endswith("partial") and any(
                _cg.is_step_root_call(_resolve(_dotted(a), aliases), "")
                for a in d.args):
            return True
    return False


def _step_roots(tree, path, aliases) -> List[Tuple[ast.AST, str]]:
    """(function or lambda, origin) for every step root defined in a file
    (kept on the tree)."""
    cached = getattr(tree, "_step_roots", None)
    if cached is not None:
        return cached
    names, lambdas = _step_root_args(tree, aliases)
    kernels = "perf/kernels/" in path.replace(os.sep, "/")
    out: List[Tuple[ast.AST, str]] = [(lam, "<lambda>") for lam in lambdas]
    for node in _walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                _resolve(_dotted(b), aliases) in _cg._AUTOGRAD_FUNCTION
                for b in node.bases):
            for meth in node.body:
                if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and meth.name in ("forward", "backward"):
                    out.append((meth, f"{node.name}.{meth.name}"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in names or _root_decorated(node, aliases) or \
                    (kernels and _counts_launches(node)):
                out.append((node, node.name))
    tree._step_roots = out
    return out


def _counts_launches(fn) -> bool:
    return any(isinstance(n, ast.Global) and
               any(name.endswith("launches") for name in n.names)
               for n in _walk(fn))


# ------------------------------------------------------------------ DLT001
def _is_import_time_device_call(q: str) -> bool:
    return q.startswith("torch.cuda.") or (
        q.startswith("torch.") and _cg.is_device_math(q))


def _rule_import_time_device_work(tree, src, path) -> List[LintViolation]:
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []

    def scan_import_time(nodes: Iterable[ast.AST]):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # decorators + default args evaluate at import; the body not
                scan_import_time(node.decorator_list)
                scan_import_time(d for d in node.args.defaults)
                scan_import_time(d for d in node.args.kw_defaults if d)
                continue
            if isinstance(node, ast.Lambda):
                continue  # body is deferred
            if isinstance(node, ast.Call):
                q = _resolve(_dotted(node.func), aliases)
                if _is_import_time_device_call(q):
                    out.append(LintViolation(
                        path, node.lineno, "DLT001",
                        f"'{q}(...)' runs at module import time — it "
                        "initialises CUDA at import and fixes a device "
                        "before any device= is read; move it into a "
                        "function"))
                    continue  # one finding per outermost offending call
            for child in ast.iter_child_nodes(node):
                scan_import_time([child])

    scan_import_time(tree.body)
    return out


# ------------------------------------------------------------------ DLT002
def _rule_global_rng_in_step(tree, src, path) -> List[LintViolation]:
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    seen: Set[int] = set()
    for fn, origin in _step_roots(tree, path, aliases):
        for node in _walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            draw = _cg.rng_of(node, _resolve(_dotted(node.func), aliases))
            if draw:
                seen.add(id(node))
                out.append(LintViolation(
                    path, node.lineno, "DLT002",
                    f"'{draw}' (global RNG) inside step root '{origin}' — "
                    "it draws from state the checkpoint does not carry "
                    "(torchGeneratorState.npz holds the network's own "
                    "generators), so a resume is no longer exact; draw "
                    "from a seeded torch.Generator (generator=)"))
    return out


# ------------------------------------------------------------------ DLT003
_CLOCKS = ("time.perf_counter", "time.time", "time.monotonic")
_SYNCS = ("synchronize", "elapsed_time", "item", "cpu", "tolist", "numpy",
          "float")


def _is_bench_file(path: str) -> bool:
    base = os.path.basename(path)
    return ("bench" in base or "perf" in base or "profile" in base
            or base == "chip_smoke.py"
            or f"{os.sep}tools{os.sep}" in path or path.startswith("tools/"))


def _rule_bench_sync(tree, src, path) -> List[LintViolation]:
    if not _is_bench_file(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []

    def direct_body(fn):
        """All nodes of fn except nested function bodies."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    for fn in _functions(tree):
        clock_lines = []
        has_sync = False
        for node in direct_body(fn):
            if isinstance(node, ast.Call):
                q = _resolve(_dotted(node.func), aliases)
                if q in _CLOCKS:
                    clock_lines.append(node.lineno)
                name = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else node.func.id if isinstance(node.func, ast.Name)
                        else "")
                if name in _SYNCS:
                    has_sync = True
        if len(clock_lines) >= 2 and not has_sync:
            out.append(LintViolation(
                path, min(clock_lines), "DLT003",
                f"function '{fn.name}' reads the clock {len(clock_lines)}x "
                "without a device sync (torch.cuda.synchronize/Event."
                "synchronize/.item()/float(...)) — CUDA launches return "
                "before the card finishes, so the stopwatch measures the "
                "enqueue"))
    return out


# ------------------------------------------------------------------ DLT004
def _rule_lock_order(tree, src, path) -> List[LintViolation]:
    out: List[LintViolation] = []

    def lock_name(expr) -> Optional[str]:
        # `self.<attr>` where the attr smells like a lock
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and "lock" in expr.attr.lower():
            return expr.attr
        return None

    for cls in _walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        # (outer, inner) -> [(method, line)]
        edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}

        # Statements are walked IN ORDER with a mutable held-set so an
        # explicit `self.x_lock.acquire()` persists across the following
        # sibling statements (incl. a try: body whose finally: releases)
        # and `release()` drops it again — the `with`-only walk missed
        # every acquire/release-sequenced ordering.
        def scan_explicit(node, held: List[str], method: str):
            for sub in _walk(node):
                if not (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("acquire", "release")):
                    continue
                ln = lock_name(sub.func.value)
                if ln is None:
                    continue
                if sub.func.attr == "acquire":
                    for h in held:
                        edges.setdefault((h, ln), []).append(
                            (method, sub.lineno))
                    held.append(ln)
                elif ln in held:
                    held.remove(ln)

        def collect(stmts, held: List[str], method: str):
            for node in stmts:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # nested defs run later, with unknown holds
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    acquired = []
                    for item in node.items:
                        ln = lock_name(item.context_expr)
                        if ln is not None:
                            for h in held + acquired:
                                edges.setdefault((h, ln), []).append(
                                    (method, node.lineno))
                            acquired.append(ln)
                    held.extend(acquired)
                    collect(node.body, held, method)
                    if acquired:
                        del held[-len(acquired):]
                    continue
                if isinstance(node, ast.Try):
                    collect(node.body, held, method)
                    for h in node.handlers:
                        collect(h.body, held, method)
                    collect(node.orelse, held, method)
                    collect(node.finalbody, held, method)
                    continue
                if isinstance(node, ast.If):
                    scan_explicit(node.test, held, method)
                    collect(node.body, held, method)
                    collect(node.orelse, held, method)
                    continue
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    scan_explicit(node.iter, held, method)
                    collect(node.body, held, method)
                    collect(node.orelse, held, method)
                    continue
                if isinstance(node, ast.While):
                    scan_explicit(node.test, held, method)
                    collect(node.body, held, method)
                    collect(node.orelse, held, method)
                    continue
                scan_explicit(node, held, method)

        for meth in cls.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                collect(meth.body, [], meth.name)

        reported = set()
        for (a, b), sites in edges.items():
            if (b, a) in edges and (b, a) not in reported and a != b:
                reported.add((a, b))
                m1, l1 = sites[0]
                m2, l2 = edges[(b, a)][0]
                out.append(LintViolation(
                    path, l1, "DLT004",
                    f"class '{cls.name}' acquires locks in inconsistent "
                    f"order: '{m1}' takes {a} -> {b} (line {l1}) but "
                    f"'{m2}' takes {b} -> {a} (line {l2}) — deadlock risk "
                    "under concurrent callers; pick one global order"))
    return out


# ------------------------------------------------------------------ DLT005
def _rule_serving_bn_fold(tree, src, path) -> List[LintViolation]:
    aliases = _import_aliases(tree)
    pi_lines: List[int] = []
    has_bn = False
    has_fold = False
    for node in _walk(tree):
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = _dotted(node) or getattr(node, "attr", "") or \
                getattr(node, "id", "")
            if "fold_bn" in d:
                has_fold = True
        if not isinstance(node, ast.Call):
            continue
        q = _resolve(_dotted(node.func), aliases)
        tail = q.rsplit(".", 1)[-1] if q else ""
        if tail == "ParallelInference":
            pi_lines.append(node.lineno)
            # ParallelInference(..., fold_bn=True) folds internally; an
            # explicit literal False is NOT a fold — that is exactly the
            # unfolded serving site the rule exists to catch
            for kw in node.keywords:
                if kw.arg == "fold_bn" and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value is False):
                    has_fold = True
        elif tail == "BatchNormalization":
            has_bn = True
        elif "fold_bn" in tail:
            has_fold = True
    if not (pi_lines and has_bn) or has_fold:
        return []
    return [LintViolation(
        path, line, "DLT005",
        "model built with BatchNormalization is served through "
        "ParallelInference without BN folding — every dispatch re-applies "
        "the BN normalize (and a train=True call on this path would run "
        "BN-train semantics on request batches); fold it exactly into the "
        "conv weights with perf.fusion.fold_bn / "
        "ParallelInference(fold_bn=True)") for line in pi_lines]


# ------------------------------------------------------------------ DLT006
def _is_storage_file(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("checkpoint/", "storage/")) \
        or os.path.basename(p) in ("storage.py", "checkpoint.py")


_BROAD_EXC = ("Exception", "BaseException")


def _rule_swallowed_storage_error(tree, src, path) -> List[LintViolation]:
    if not _is_storage_file(path):
        return []
    out: List[LintViolation] = []

    def handler_is_broad(h: ast.ExceptHandler) -> bool:
        if h.type is None:  # bare except
            return True
        types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        for t in types:
            d = _dotted(t) or ""
            if d.rsplit(".", 1)[-1] in _BROAD_EXC:
                return True
        return False

    # the CALLED METHOD itself must be a reporting primitive — matching a
    # substring anywhere in the dotted path would let `self.catalog.
    # refresh()` (…log…) silence the rule
    _REPORTERS = {"debug", "info", "warning", "warn", "error", "exception",
                  "critical", "log", "print", "_fail"}

    def handler_surfaces(h: ast.ExceptHandler) -> bool:
        """Re-raise, log, warn, or stash the bound exception somewhere."""
        bound = h.name
        for node in _walk(h):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                d = (_dotted(node.func) or "").lower()
                if d.rsplit(".", 1)[-1] in _REPORTERS:
                    return True
            # ``self._write_err = e`` — deferred re-raise pattern
            if bound and isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == bound:
                return True
        return False

    for node in _walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for h in node.handlers:
            if handler_is_broad(h) and not handler_surfaces(h):
                what = ("bare except" if h.type is None else
                        f"except {_dotted(h.type) if not isinstance(h.type, ast.Tuple) else 'Exception'}")
                out.append(LintViolation(
                    path, h.lineno, "DLT006",
                    f"{what} in checkpoint/storage code swallows the error "
                    "without re-raising or logging — a durability fault "
                    "eaten here surfaces as a dead run at restore time; "
                    "narrow the handler, log it, or waive inline"))
    return out


# ------------------------------------------------------------------ DLT007
_METRIC_METHODS = ("counter", "gauge", "histogram")
_COUNTER_DICT_CTORS = ("dict", "Counter", "defaultdict", "OrderedDict")


def _is_registry_receiver(recv: Optional[str]) -> bool:
    if not recv:
        return False
    last = recv.split(".")[-1].lower()
    return "registry" in last or last in ("reg", "metrics")


def _rule_metric_registration(tree, src, path) -> List[LintViolation]:
    out: List[LintViolation] = []
    for node in _walk(tree):
        # (a) registry instrument calls must carry unit + help
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _METRIC_METHODS and \
                _is_registry_receiver(_dotted(node.func.value)):
            # signature: (name, unit, help, ...) — positionals count
            present = {("name", "unit", "help")[i]
                       for i in range(min(3, len(node.args)))}
            empty = set()
            for i, a in enumerate(node.args[:3]):
                if isinstance(a, ast.Constant) and a.value == "":
                    empty.add(("name", "unit", "help")[i])
            for kw in node.keywords:
                if kw.arg in ("unit", "help"):
                    present.add(kw.arg)
                    if isinstance(kw.value, ast.Constant) and \
                            kw.value.value == "":
                        empty.add(kw.arg)
            missing = sorted(({"unit", "help"} - present) | empty)
            if missing:
                out.append(LintViolation(
                    path, node.lineno, "DLT007",
                    f"metric registered via .{node.func.attr}(...) without "
                    f"{' and '.join(missing)} — every metric needs a unit "
                    "and help text (an unlabeled number on a dashboard is "
                    "a guess)"))
            continue
        # (b) bare counter dicts
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        bare = isinstance(value, ast.Dict) and not value.keys
        if isinstance(value, ast.Call):
            tail = (_dotted(value.func) or "").rsplit(".", 1)[-1]
            bare = tail in _COUNTER_DICT_CTORS and not value.args \
                and not value.keywords or tail == "defaultdict"
        if not bare:
            continue
        for t in targets:
            name = (t.attr if isinstance(t, ast.Attribute)
                    else t.id if isinstance(t, ast.Name) else "")
            low = name.lower()
            if low == "counters" or low.endswith("_counters"):
                out.append(LintViolation(
                    path, node.lineno, "DLT007",
                    f"bare counter dict '{name}' — register metrics in an "
                    "obs.MetricsRegistry with units and help text instead "
                    "(or absorb the surface via obs.absorb_* and waive "
                    "inline)"))
    return out


# ------------------------------------------------------------------ DLT008
def _is_bounded_buffer_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("serving/", "parallel/", "datasets/",
                                    "storage/", "checkpoint/",
                                    "retrieval/"))


def _rule_unbounded_queue(tree, src, path) -> List[LintViolation]:
    if not _is_bounded_buffer_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _resolve(_dotted(node.func), aliases) != "queue.Queue":
            continue
        # maxsize is the single positional; a literal 0 (stdlib's
        # "infinite") is exactly as unbounded as omitting it
        bound = None
        if node.args:
            bound = node.args[0]
        for kw in node.keywords:
            if kw.arg == "maxsize":
                bound = kw.value
        unbounded = bound is None or (isinstance(bound, ast.Constant)
                                      and bound.value == 0)
        if unbounded:
            out.append(LintViolation(
                path, node.lineno, "DLT008",
                "unbounded queue.Queue() in a serving/parallel/data/"
                "storage path — a stalled consumer grows host memory "
                "without limit and producers wait forever; pass maxsize= "
                "with explicit full-queue semantics (shed/timeout), or "
                "waive inline"))
    return out


# ------------------------------------------------------------------ DLT009
def _rule_host_work_in_compression(tree, src, path) -> List[LintViolation]:
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []

    def in_scope_functions():
        """(fn, origin) for compression-path functions: name contains
        'compress', or any method of a class whose name contains
        'Compression'."""
        for node in _walk(tree):
            if isinstance(node, ast.ClassDef) and "Compression" in node.name:
                for meth in _walk(node):
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        yield meth, f"{node.name}.{meth.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and "compress" in node.name.lower():
                yield node, node.name

    seen: Set[int] = set()
    for fn, origin in in_scope_functions():
        if id(fn) in seen or not _uses_device_math(fn, aliases):
            continue
        seen.add(id(fn))
        for node in _walk(fn):
            if not isinstance(node, ast.Call):
                continue
            hazard = _host_work(node, aliases)
            if hazard:
                out.append(LintViolation(
                    path, node.lineno, "DLT009",
                    f"{hazard} inside gradient-compression path "
                    f"'{origin}' — compress/encode/decode runs every "
                    "step between the backward and the collective, where "
                    "a host read stalls the stream and the launch queue; "
                    "keep the pass in torch on the card (or waive inline "
                    "for a deliberately host-side helper)"))
    return out


# ------------------------------------------------------------------ DLT010
_FLOAT_DTYPES = {
    "torch.float32": "float32", "torch.float": "float32",
    "torch.float64": "float64", "torch.double": "float64",
}


def _rule_float_cast_in_quant(tree, src, path) -> List[LintViolation]:
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []

    def in_scope_functions():
        """(fn, origin): any method of a class whose name contains
        'Quantized', or a function whose name contains 'quant' that also
        does torch device math (pure-host helpers are exempt)."""
        for node in _walk(tree):
            if isinstance(node, ast.ClassDef) and "Quantized" in node.name:
                for meth in _walk(node):
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        yield meth, f"{node.name}.{meth.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and "quant" in node.name.lower() \
                    and _uses_device_math(node, aliases):
                yield node, node.name

    def dtype_of(a) -> Optional[str]:
        if isinstance(a, ast.Constant) and a.value in (
                "float32", "float64", "torch.float32", "torch.float64",
                "torch.FloatTensor", "torch.DoubleTensor"):
            return "float64" if "64" in a.value or "Double" in a.value \
                else "float32"
        return _FLOAT_DTYPES.get(_resolve(_dotted(a), aliases))

    def cast_target(node: ast.Call) -> Optional[str]:
        """'float32'/'float64' when the call is a flagged float cast."""
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "float" and not node.args:
                return "float32"
            if attr == "double" and not node.args:
                return "float64"
            if attr in ("to", "type"):
                for a in list(node.args) + [kw.value for kw in node.keywords
                                            if kw.arg in (None, "dtype")]:
                    t = dtype_of(a)
                    if t:
                        return t
                return None
        if _resolve(_dotted(node.func), aliases) == "numpy.float64":
            return "float64"
        # float64 anywhere in scope: a tensor made or cast in float64
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if dtype_of(a) == "float64":
                return "float64"
        return None

    seen: Set[int] = set()
    for fn, origin in in_scope_functions():
        for node in _walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            t = cast_target(node)
            if t:
                seen.add(id(node))
                out.append(LintViolation(
                    path, node.lineno, "DLT010",
                    f"{t} cast inside quantized-inference path "
                    f"'{origin}' — re-floating a tensor mid-path defeats "
                    "the int8 compute (dequant-per-element in the hot "
                    "loop) while every numeric test still passes; keep "
                    "tensors int8 until the single per-layer requantize "
                    "(or waive inline for a deliberate fp32 boundary)"))
    return out


# ------------------------------------------------------------------ DLT011
_GLOBAL_RNG_CALLS = {
    "random.shuffle", "random.sample", "random.choice", "random.random",
    "random.randint", "random.uniform",
    "numpy.random.shuffle", "numpy.random.permutation",
    "numpy.random.choice", "numpy.random.randint", "numpy.random.random",
    "numpy.random.rand", "numpy.random.randn", "numpy.random.seed",
}


def _is_data_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("datasets/", "parallel/"))


def _rule_unseeded_global_rng(tree, src, path) -> List[LintViolation]:
    if not _is_data_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        q = _resolve(_dotted(node.func), aliases)
        draw = q if q in _GLOBAL_RNG_CALLS else None
        if draw is None and q.startswith("torch."):
            draw = _cg.rng_of(node, q)
        if draw:
            out.append(LintViolation(
                path, node.lineno, "DLT011",
                f"'{draw}(...)' draws from module-level RNG state in a "
                "datasets/parallel path — a deterministic-epoch hazard: "
                "fleet-true resume and any-world bitwise epochs need "
                "every shuffle to be a pure function of (seed, epoch), "
                "and global state also races across prefetch threads; "
                "use a seeded np.random.default_rng(seed) / "
                "random.Random(seed) / torch.Generator instance (or waive "
                "inline for a deliberately non-deterministic path)"))
    return out


# ------------------------------------------------------------------ DLT012
def _is_hot_path_file(path: str) -> bool:
    p = path.replace(os.sep, "/")
    if any(seg in p for seg in ("serving/", "parallel/")):
        return True
    return p.endswith(("nn/multilayer.py", "nn/graph.py"))


_AUTOTUNE_TAILS = ("FlopCounterMode", "training_activation_bytes",
                   "memory_snapshot", "step_cost", "plan_memory")


def _rule_autotune_work_in_hot_path(tree, src, path) -> List[LintViolation]:
    if not _is_hot_path_file(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        q = _resolve(_dotted(node.func), aliases)
        tail = q.rsplit(".", 1)[-1]
        hazard = None
        if tail in _AUTOTUNE_TAILS:
            hazard = f"'{tail}(...)'"
        elif q.endswith("perf.autotune.autotune"):
            hazard = "'perf.autotune.autotune(...)' (an autotune search)"
        elif tail in ("build", "load") and (
                q.endswith("_build." + tail) or ".kernels._build." in q):
            hazard = f"'_build.{tail}(...)' (a kernel build)"
        elif q.startswith("subprocess.") and "nvcc" in ast.dump(node):
            hazard = "an nvcc subprocess (a kernel build)"
        elif q == "torch.device" and node.args and isinstance(
                node.args[0], ast.Constant) and node.args[0].value == "meta":
            hazard = "'torch.device(\"meta\")' (a meta-device estimate)"
        elif any(kw.arg == "device" and isinstance(kw.value, ast.Constant)
                 and kw.value.value == "meta" for kw in node.keywords):
            hazard = "'device=\"meta\"' (a meta-device estimate)"
        if hazard:
            out.append(LintViolation(
                path, node.lineno, "DLT012",
                f"{hazard} in a serving/training hot path — meta-device "
                "estimates, allocator snapshots and kernel builds cost "
                "seconds on a path budgeted in microseconds; these are "
                "autotune-time tools (perf/autotune.py, perf/planner.py) "
                "— thread their results in via a TuningRecord/plan, or "
                "waive inline for a deliberate offline call"))
    return out


# ------------------------------------------------------------------ DLT013
_RETRIEVAL_HOT_TOKENS = ("score", "topk", "probe")


def _is_retrieval_path(path: str) -> bool:
    return "retrieval/" in path.replace(os.sep, "/")


def _rule_host_work_in_retrieval(tree, src, path) -> List[LintViolation]:
    if not _is_retrieval_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    roots = {id(fn) for fn, _ in _step_roots(tree, path, aliases)}

    def in_scope_functions():
        for node in _functions(tree):
            name = node.name.lower()
            if (id(node) in roots
                    or any(t in name for t in _RETRIEVAL_HOT_TOKENS)):
                if _uses_device_math(node, aliases):
                    yield node

    # dedup on the CALL node: a hot-path function nested inside another is
    # walked by both
    seen_calls: Set[int] = set()
    for fn in in_scope_functions():
        for node in _walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen_calls:
                continue
            hazard = _host_work(node, aliases)
            if hazard:
                seen_calls.add(id(node))
                out.append(LintViolation(
                    path, node.lineno, "DLT013",
                    f"{hazard} inside retrieval hot-path function "
                    f"'{fn.name}' — the scoring path keeps the whole "
                    "query batch on the card up to the device top-k with "
                    "no host syncs; a readback or host distance math here "
                    "reintroduces the per-query host round-trip the "
                    "device index exists to kill; keep it in torch (or "
                    "waive inline for a deliberately host-side helper)"))
    return out


# ------------------------------------------------------------------ DLT014
_PACK_TOKENS = ("pack", "unpack", "nibble", "adc", "pq")


def _is_pack_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return "retrieval/" in p or "quant/" in p


def _rule_host_work_in_pack_path(tree, src, path) -> List[LintViolation]:
    if not _is_pack_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []

    def in_scope_functions():
        for node in _functions(tree):
            name = node.name.lower()
            if any(t in name for t in _PACK_TOKENS) \
                    and _uses_device_math(node, aliases):
                yield node

    seen_calls: Set[int] = set()
    for fn in in_scope_functions():
        for node in _walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen_calls:
                continue
            hazard = _host_work(node, aliases)
            if hazard:
                seen_calls.add(id(node))
                out.append(LintViolation(
                    path, node.lineno, "DLT014",
                    f"{hazard} inside packed-code function '{fn.name}' — "
                    "packed int4/PQ codes stay resident on the card and "
                    "unpack inside the scorer (quant/pack.py "
                    "unpack_nibbles, the int4_dot / adc kernels); host-"
                    "side unpacking materialises the table the packing "
                    "shrank and syncs per dispatch; keep it in torch (or "
                    "waive inline for a deliberately host-side build/test "
                    "helper)"))
    return out


# ------------------------------------------------------------------ DLT015
def _is_kernel_wrapper_path(path: str) -> bool:
    return "perf/kernels/" in path.replace(os.sep, "/")


def _calls_plain(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and
               (_dotted(n.func) or "").rsplit(".", 1)[-1].endswith("_plain")
               for n in _walk(node))


def _rule_host_work_in_kernel_launch(tree, src, path) -> List[LintViolation]:
    if not _is_kernel_wrapper_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    seen: Set[int] = set()
    for fn in _functions(tree):
        if not _counts_launches(fn):
            continue
        for node in _walk(fn):
            if id(node) in seen:
                continue
            hazard = fix = None
            if isinstance(node, ast.Call):
                hazard = _host_work(node, aliases)
                fix = ("a launch path runs once per call on the device "
                       "path; validate shapes from .shape / .stride(), "
                       "never from tensor values")
            elif isinstance(node, ast.Try) and any(
                    _calls_plain(h) for h in node.handlers):
                hazard = "'try' whose handler takes the plain version"
                fix = ("a CUDA tensor launches its kernel or raises "
                       "(ROADMAP's no-fallback rule): a fallback passes "
                       "every CPU test and hides a build or launch "
                       "failure on the card")
            if hazard:
                seen.add(id(node))
                out.append(LintViolation(
                    path, node.lineno, "DLT015",
                    f"{hazard} inside kernel launch function '{fn.name}' "
                    f"— {fix} (or waive inline for a deliberate "
                    "exception)"))
    return out


# ------------------------------------------------------------------ DLT016
def _is_fleet_serving_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("fleet/", "serving/"))


# blocking client entry points → the 1-based positional slot that can
# carry the timeout (None: only the ``timeout=`` keyword can)
_BLOCKING_IO_CALLS = {
    "urllib.request.urlopen": 3,
    "http.client.HTTPConnection": 3,
    "http.client.HTTPSConnection": 3,
    "socket.create_connection": 2,
    "requests.get": None,
    "requests.post": None,
    "requests.put": None,
    "requests.delete": None,
    "requests.request": None,
}


def _rule_blocking_io_without_timeout(tree, src, path
                                      ) -> List[LintViolation]:
    """Outbound socket/HTTP-client calls in fleet/ + serving/ paths must
    carry an explicit timeout: the router fans one client request out to
    replicas, so a single hung upstream without a timeout wedges a
    handler thread forever — under a burst, ALL of them — and the
    default for every one of these stdlib calls is to block forever."""
    if not _is_fleet_serving_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        q = _resolve(_dotted(node.func), aliases)
        if q not in _BLOCKING_IO_CALLS:
            continue
        if any(kw.arg == "timeout" for kw in node.keywords):
            continue
        slot = _BLOCKING_IO_CALLS[q]
        if slot is not None and len(node.args) >= slot:
            continue
        out.append(LintViolation(
            path, node.lineno, "DLT016",
            f"'{q}(...)' without an explicit timeout in a fleet/serving "
            "path — these calls block forever by default, so one hung "
            "replica wedges a router/server handler thread (and under a "
            "burst, all of them); pass timeout= (or waive inline for a "
            "deliberately unbounded wait)"))
    return out


# ------------------------------------------------------------------ DLT020
_DECODE_TOKENS = ("decode", "sample", "generate", "stream", "token")


def _is_serving_nn_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("serving/", "nn/"))


def _rule_per_token_host_transfer(tree, src, path) -> List[LintViolation]:
    """DLT020: host transfers inside loop bodies of decode/sampling
    functions in serving/ + nn/ paths. The decode tier's contract is one
    dispatch advancing every active session and one bulk readback per
    dispatch; a sync inside the per-token loop turns that into sessions ×
    tokens host syncs."""
    if not _is_serving_nn_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []

    def in_scope_functions():
        for node in _functions(tree):
            name = node.name.lower()
            if any(t in name for t in _DECODE_TOKENS) \
                    and _uses_device_math(node, aliases):
                yield node

    # dedup on the CALL node: nested loops walk inner statements twice
    seen_calls: Set[int] = set()
    for fn in in_scope_functions():
        for loop in _walk(fn):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for stmt in loop.body + loop.orelse:
                for node in _walk(stmt):
                    if not isinstance(node, ast.Call) \
                            or id(node) in seen_calls:
                        continue
                    hazard = _host_work(node, aliases)
                    if hazard is None:
                        continue
                    seen_calls.add(id(node))
                    out.append(LintViolation(
                        path, node.lineno, "DLT020",
                        f"{hazard} inside a loop body of decode/sampling "
                        f"function '{fn.name}' — the decode tier makes "
                        "ONE dispatch advance every active session with "
                        "ONE bulk readback per dispatch; a host transfer "
                        "inside the per-token loop reintroduces sessions "
                        "x tokens host syncs; hoist the readback out of "
                        "the loop (or waive inline for a deliberately "
                        "host-side helper)"))
    return out


# ------------------------------------------------- DLT017 (interprocedural)
# consequence phrasing per hazard kind, for the message
_DLT017_REASON = {
    "rng": ("global RNG", "draws from state the checkpoint does not carry, "
            "so a resume is no longer exact"),
    "np": ("host numpy", "mixed host/device code on the step's path — "
           "host math here copies device values back or stalls the "
           "launch queue every step"),
    "sync": ("host sync", "waits for the card and reads back on every "
             "step or dispatch"),
}


def _repo_rule_host_work_from_step(graph: "_cg.CallGraph"
                                   ) -> List[LintViolation]:
    """DLT017: the host-work checks over everything reachable from a step
    root. A root's own body is checked for host syncs only (its global-RNG
    draws are DLT002's; eager torch runs the body every step, where a
    traced JAX body could not sync at all). Each hazard reports once,
    with the shortest root chain."""
    best: Dict[Tuple[str, int, str], Tuple[Tuple[str, ...], str]] = {}
    for qname, chain in graph.reachable_from_entries().items():
        fn = graph.functions.get(qname)
        if fn is None:
            continue
        root = qname in graph.step_roots
        for hz in fn.hazards:
            if root and hz.kind != "sync":
                continue
            if hz.kind == "np" and not fn.uses_device:
                continue  # pure-host helper: no device value involved
            key = (fn.path, hz.lineno, hz.detail)
            if key not in best or len(chain) < len(best[key][0]):
                best[key] = ((qname,) if root else chain, hz.kind)
    out: List[LintViolation] = []
    for (path, lineno, detail), (chain, kind) in sorted(best.items()):
        label, consequence = _DLT017_REASON[kind]
        hops = len(chain) - 1
        where = (f"inside step root '{chain[0]}'" if not hops else
                 f"is reachable from step root '{chain[0]}' via "
                 f"{' -> '.join(chain)} ({hops} call hop"
                 f"{'s' if hops != 1 else ''} from the step root)")
        out.append(LintViolation(
            path, lineno, "DLT017",
            f"'{detail}' ({label}) {where} — "
            f"{consequence}; hoist the host work out of the step's path "
            "or keep the value on the card (or waive inline for a "
            "deliberate host read)"))
    return out


# ------------------------------------------------- DLT018 (interprocedural)
def _is_lock_io_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("fleet/", "serving/", "checkpoint/",
                                    "parallel/"))


def _repo_rule_cross_module_locks(graph: "_cg.CallGraph"
                                  ) -> List[LintViolation]:
    """DLT018: (a) opposite-order lock pairs anywhere in the repo, with
    held-sets propagated through resolved call edges (same-class pairs
    that DLT004 already sees from direct nesting are left to DLT004);
    (b) blocking I/O — direct or via a callee — while a lock is held, in
    serving/fleet/checkpoint/parallel paths."""
    out: List[LintViolation] = []

    # witness: (fn qname, file, line, via-callee-or-None)
    wit: Dict[Tuple[str, str], List[Tuple[str, str, int, Optional[str]]]] = {}
    for qname, acqs in graph.lock_acqs.items():
        fn = graph.functions[qname]
        for a in acqs:
            for h in a.held:
                if h != a.lock:
                    wit.setdefault((h, a.lock), []).append(
                        (qname, fn.path, a.lineno, None))
    for qname, edges in graph.edges.items():
        fn = graph.functions[qname]
        for e in edges:
            if not e.held:
                continue
            for lk in sorted(graph.acq_closure(e.callee)):
                for h in e.held:
                    if lk != h:
                        wit.setdefault((h, lk), []).append(
                            (qname, fn.path, e.lineno, e.callee))

    adj: Dict[str, Set[str]] = {}
    for (a, b) in wit:
        adj.setdefault(a, set()).add(b)

    def bfs_path(src: str, dst: str) -> Optional[List[str]]:
        prev: Dict[str, str] = {src: src}
        frontier = [src]
        while frontier:
            nxt = []
            for n in frontier:
                for m in sorted(adj.get(n, ())):
                    if m in prev:
                        continue
                    prev[m] = n
                    if m == dst:
                        path = [m]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(m)
            frontier = nxt
        return None

    def describe(w) -> str:
        qname, fpath, line, via = w
        base = f"'{qname}' ({os.path.basename(fpath)}:{line})"
        return f"{base} via call to '{via}'" if via else base

    reported: Set[frozenset] = set()
    for (a, b) in sorted(wit):
        if (b, a) in wit:  # 2-cycle
            pair = frozenset((a, b))
            if pair in reported:
                continue
            reported.add(pair)
            owner_a, owner_b = a.rsplit(".", 1)[0], b.rsplit(".", 1)[0]
            direct_ab = any(w[3] is None for w in wit[(a, b)])
            direct_ba = any(w[3] is None for w in wit[(b, a)])
            if owner_a == owner_b and direct_ab and direct_ba:
                continue  # same class, both orders directly nested: DLT004's
            w1, w2 = wit[(a, b)][0], wit[(b, a)][0]
            out.append(LintViolation(
                w1[1], w1[2], "DLT018",
                f"locks '{a}' and '{b}' are acquired in opposite orders: "
                f"{describe(w1)} takes '{a}' then '{b}', but {describe(w2)} "
                f"takes '{b}' then '{a}' — cross-module deadlock risk under "
                "concurrent callers; pick one global order (or waive inline "
                "if the two orders are provably never concurrent)"))
        else:
            cyc = bfs_path(b, a)
            if not cyc:
                continue
            nodes = frozenset(cyc) | {a}
            if nodes in reported:
                continue
            reported.add(nodes)
            w1 = wit[(a, b)][0]
            ring = " -> ".join([a, b] + cyc[1:])
            out.append(LintViolation(
                w1[1], w1[2], "DLT018",
                f"lock-acquisition cycle {ring}: {describe(w1)} takes "
                f"'{a}' then '{b}' and the remaining edges close the loop "
                "— cross-module deadlock risk under concurrent callers; "
                "break one edge of the cycle (or waive inline if the "
                "orders are provably never concurrent)"))

    seen_io: Set[Tuple[str, int, str]] = set()
    for qname, ios in graph.io_held.items():
        fn = graph.functions[qname]
        if not _is_lock_io_path(fn.path):
            continue
        for what, lineno, held in ios:
            if not held or (fn.path, lineno, what) in seen_io:
                continue
            seen_io.add((fn.path, lineno, what))
            out.append(LintViolation(
                fn.path, lineno, "DLT018",
                f"blocking '{what}' while holding lock '{held[-1]}' in "
                f"'{qname}' — every thread that needs the lock convoys "
                "behind this wait; move the blocking call outside the "
                "critical section (or waive inline for a deliberately "
                "serialized wait)"))
    for qname, edges in graph.edges.items():
        fn = graph.functions[qname]
        if not _is_lock_io_path(fn.path):
            continue
        for e in edges:
            if not e.held:
                continue
            for what in sorted(graph.io_closure(e.callee)):
                if (fn.path, e.lineno, what) in seen_io:
                    continue
                seen_io.add((fn.path, e.lineno, what))
                out.append(LintViolation(
                    fn.path, e.lineno, "DLT018",
                    f"call to '{e.callee}' performs blocking '{what}' "
                    f"while '{qname}' holds lock '{e.held[-1]}' — every "
                    "thread that needs the lock convoys behind this wait; "
                    "move the call outside the critical section (or waive "
                    "inline for a deliberately serialized wait)"))
    return out


# ------------------------------------------------- DLT019 (interprocedural)
def _repo_rule_thread_lifecycle(graph: "_cg.CallGraph"
                                ) -> List[LintViolation]:
    """DLT019: a ``threading.Thread`` started without ``daemon=True`` and
    without a recorded ``join()``/stop path leaks on shutdown."""
    cls_joins: Dict[str, Set[str]] = {}
    cls_daemon: Dict[str, Set[str]] = {}
    mod_joins: Dict[str, bool] = {}
    for fn in graph.functions.values():
        if fn.joins:
            mod_joins[fn.module] = True
        if fn.cls:
            cls_joins.setdefault(fn.cls, set()).update(fn.joins)
            cls_daemon.setdefault(fn.cls, set()).update(fn.daemon_sets)

    out: List[LintViolation] = []
    for qname in sorted(graph.functions):
        fn = graph.functions[qname]
        for th in fn.thread_starts:
            if th.daemon in ("true", "dynamic"):
                continue  # explicit daemon choice (dynamic: caller decides)
            ok = False
            if th.assigned and th.direct:
                if th.assigned in fn.joins or th.assigned in fn.daemon_sets \
                        or th.assigned in fn.returns:
                    ok = True  # joined here, daemonized, or handed to caller
                elif th.assigned.startswith("self.") and fn.cls and (
                        th.assigned in cls_joins.get(fn.cls, ())
                        or th.assigned in cls_daemon.get(fn.cls, ())):
                    ok = True  # drain/stop path elsewhere in the class
            else:
                # pooled into a collection / comprehension: accept any join
                # in the same function, class, or module as the stop path
                if fn.joins or (fn.cls and cls_joins.get(fn.cls)) or \
                        mod_joins.get(fn.module):
                    ok = True
            if not ok:
                out.append(LintViolation(
                    fn.path, th.lineno, "DLT019",
                    f"threading.Thread started in '{qname}' without "
                    "daemon=True or a recorded join()/stop path — a "
                    "non-daemon thread nobody joins blocks interpreter "
                    "exit and leaks across fleet drain/restart; set "
                    "daemon=True, or keep the handle and join it on the "
                    "stop path (or waive inline for a deliberately "
                    "detached worker)"))
    return out


# ------------------------------------------------------------------ DLT021
def _is_lake_io_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(seg in p for seg in ("checkpoint/cloud", "checkpoint/emulator",
                                    "tools/lake"))


_UNBOUNDED_READ_METHODS = ("read", "recv", "readline")


def _rule_unbounded_lake_io(tree, src, path) -> List[LintViolation]:
    """DLT021: the lake wire paths move attacker-sized bytes between
    processes, so every read is byte-bounded and every socket call
    carries a deadline (DLT016's scope extended to checkpoint/cloud,
    checkpoint/emulator and tools/lake). A zero-argument
    ``.read()``/``.recv()``/``.readline()`` trusts the peer to stop
    sending; a timeout-less connection trusts it to keep answering —
    the retry layer can only bound faults the client surfaces."""
    if not _is_lake_io_path(path):
        return []
    aliases = _import_aliases(tree)
    out: List[LintViolation] = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        # (a) unbounded reads: method calls with no positional byte bound
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _UNBOUNDED_READ_METHODS
                and not node.args):
            out.append(LintViolation(
                path, node.lineno, "DLT021",
                f"'.{node.func.attr}()' without a byte bound in a lake "
                "wire path — an unbounded response/socket read lets one "
                "hostile or wedged peer allocate arbitrary host memory; "
                "pass an explicit size (validate Content-Length first, "
                "utils/http.parse_content_length) or waive inline for a "
                "provably bounded stream"))
            continue
        # (b) DLT016's blocking-call table, same check, lake scope
        q = _resolve(_dotted(node.func), aliases)
        if q not in _BLOCKING_IO_CALLS:
            continue
        if any(kw.arg == "timeout" for kw in node.keywords):
            continue
        slot = _BLOCKING_IO_CALLS[q]
        if slot is not None and len(node.args) >= slot:
            continue
        out.append(LintViolation(
            path, node.lineno, "DLT021",
            f"'{q}(...)' without an explicit timeout in a lake wire "
            "path — the stdlib default blocks forever, so one stalled "
            "object-store server hangs the training run instead of "
            "tripping the retry schedule; pass timeout= (or waive "
            "inline for a deliberately unbounded wait)"))
    return out


# ----------------------------------------------------------------- harness
_RULES = (
    _rule_import_time_device_work,
    _rule_global_rng_in_step,
    _rule_bench_sync,
    _rule_lock_order,
    _rule_serving_bn_fold,
    _rule_swallowed_storage_error,
    _rule_metric_registration,
    _rule_unbounded_queue,
    _rule_host_work_in_compression,
    _rule_float_cast_in_quant,
    _rule_unseeded_global_rng,
    _rule_autotune_work_in_hot_path,
    _rule_host_work_in_retrieval,
    _rule_host_work_in_pack_path,
    _rule_host_work_in_kernel_launch,
    _rule_blocking_io_without_timeout,
    _rule_per_token_host_transfer,
    _rule_unbounded_lake_io,
)


_REPO_RULES = (
    _repo_rule_host_work_from_step,
    _repo_rule_cross_module_locks,
    _repo_rule_thread_lifecycle,
)

# content-hash caches so the tier-1 gate re-lints only what changed:
# per-file raw rule results, and the repo-rule results for a working set
_FILE_RAW_CACHE: Dict[str, Tuple[str, List[LintViolation]]] = {}
_REPO_RAW_CACHE: Dict[frozenset, List[LintViolation]] = {}


def clear_caches():
    """Drop every lint/call-graph cache (cold-run timing, tests)."""
    _FILE_RAW_CACHE.clear()
    _REPO_RAW_CACHE.clear()
    _cg.clear_cache()


def _waived(v: LintViolation, lines: List[str], file_waivers: Set[str]) -> bool:
    if v.rule in file_waivers:
        return True
    if 1 <= v.line <= len(lines):
        text = lines[v.line - 1]
        if "lint: disable" in text and (v.rule in text
                                        or text.rstrip().endswith("disable")):
            return True
    return False


def _parse_file_waivers(lines: List[str]) -> Set[str]:
    return {
        part.strip().split()[0].rstrip(")")
        for line in lines if "lint: disable-file=" in line
        for part in line.split("lint: disable-file=")[1].split(",")
        if part.strip()
    }


def _lint_file_raw(path: str, src: str) -> List[LintViolation]:
    """All per-file rule results, UNFILTERED by waivers (the audit needs
    the raw set to decide which waivers still suppress something)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintViolation(path, e.lineno or 0, "DLT000",
                              f"syntax error: {e.msg}")]
    out: List[LintViolation] = []
    for rule in _RULES:
        out.extend(rule(tree, src, path))
    return out


def lint_file(path: str, src: Optional[str] = None) -> List[LintViolation]:
    """Per-file rules (DLT000-016, DLT020-021) on one file; waivers
    applied. The interprocedural families (DLT017-019) need the whole-repo
    graph and only run under :func:`lint_paths`."""
    if src is None:
        with open(path, encoding="utf-8") as f:
            src = f.read()
    lines = src.splitlines()
    return sorted(
        (v for v in _lint_file_raw(path, src)
         if not _waived(v, lines, _parse_file_waivers(lines))),
        key=lambda v: (v.file, v.line, v.rule))


def _read_and_raw(path: str) -> Tuple[str, List[LintViolation]]:
    """(source, raw per-file violations) with content-hash caching."""
    apath = os.path.abspath(path)
    with open(apath, encoding="utf-8") as f:
        src = f.read()
    sha = hashlib.sha1(src.encode("utf-8", "replace")).hexdigest()
    cached = _FILE_RAW_CACHE.get(apath)
    if cached is not None and cached[0] == sha:
        return src, cached[1]
    raw = _lint_file_raw(apath, src)
    _FILE_RAW_CACHE[apath] = (sha, raw)
    return src, raw


def _repo_raw(files: List[str]) -> List[LintViolation]:
    """Raw (unwaived) interprocedural findings over a file working set,
    cached on the frozenset of (path, content-hash)."""
    graph = _cg.build_graph(files)
    key = frozenset((s.path, s.sha) for s in graph.summaries)
    cached = _REPO_RAW_CACHE.get(key)
    if cached is None:
        cached = []
        for rule in _REPO_RULES:
            cached.extend(rule(graph))
        _REPO_RAW_CACHE.clear()  # one working set at a time is enough
        _REPO_RAW_CACHE[key] = cached
    return cached


def lint_paths(paths: Iterable[str]) -> List[LintViolation]:
    """Per-file rules on every file plus the interprocedural DLT017-019
    families over the call graph of the whole working set."""
    files = _cg.discover_files(paths)
    out: List[LintViolation] = []
    srcs: Dict[str, str] = {}
    for f in files:
        src, raw = _read_and_raw(f)
        apath = os.path.abspath(f)
        srcs[apath] = src
        lines = src.splitlines()
        out.extend(v for v in raw
                   if not _waived(v, lines, _parse_file_waivers(lines)))
    for v in _repo_raw(files):
        src = srcs.get(v.file)
        if src is None:  # finding in a file outside the lint set (unlikely)
            out.append(v)
            continue
        lines = src.splitlines()
        if not _waived(v, lines, _parse_file_waivers(lines)):
            out.append(v)
    return sorted(out, key=lambda v: (v.file, v.line, v.rule))


# ------------------------------------------------------------ waiver audit
@dataclasses.dataclass(frozen=True)
class StaleWaiver:
    """A ``lint: disable`` comment that no longer suppresses anything."""
    file: str
    line: int               # 0 for file-wide waivers
    rules: Tuple[str, ...]  # () = bare line-waiver with no rule list
    scope: str              # "inline" | "file"

    def __str__(self):
        what = ",".join(self.rules) or "<all>"
        where = f"{self.file}:{self.line}" if self.scope == "inline" \
            else self.file
        return (f"{where}: stale waiver ({what}) — no {self.scope}-scope "
                "finding left to suppress; delete it")


def raw_findings(paths: Iterable[str]) -> List[LintViolation]:
    """Every finding over the working set, per-file and interprocedural,
    with NO waiver applied: what :func:`audit_waivers` holds the comments
    against, and what ``chip_smoke.py`` matches the syncs the card reports
    to (a sync must sit on a line some rule flags)."""
    files = _cg.discover_files(paths)
    out: List[LintViolation] = []
    for f in files:
        out.extend(_read_and_raw(f)[1])
    out.extend(_repo_raw(files))
    return sorted(out, key=lambda v: (v.file, v.line, v.rule))


def audit_waivers(paths: Iterable[str]) -> List[StaleWaiver]:
    """Every waiver comment in the working set that suppresses NO raw
    finding (per-file or interprocedural). Stale waivers hide real
    regressions: the rule fires again one refactor later and the comment
    swallows it silently."""
    files = _cg.discover_files(paths)
    raw_by_file: Dict[str, List[LintViolation]] = {}
    for v in raw_findings(files):
        raw_by_file.setdefault(v.file, []).append(v)

    out: List[StaleWaiver] = []
    for f in files:
        summ = _cg.summarize_file(f)
        raws = raw_by_file.get(summ.path, [])
        for line, rules in sorted(summ.inline_waivers.items()):
            hit = any(v.line == line and (not rules or v.rule in rules)
                      for v in raws)
            if not hit:
                out.append(StaleWaiver(summ.path, line, rules, "inline"))
        for rule in sorted(summ.file_waivers):
            if not any(v.rule == rule for v in raws):
                out.append(StaleWaiver(summ.path, 0, (rule,), "file"))
    return out


def DEFAULT_TARGETS(repo_root: str) -> List[str]:
    """The port's lint surface: the package, ``chip_smoke.py``, and the
    repo-root tools that import ``torch`` or the port."""
    out = [os.path.join(repo_root, "deeplearning4j_tpu_torch"),
           os.path.join(repo_root, "chip_smoke.py")]
    tools = os.path.join(repo_root, "tools")
    for name in sorted(os.listdir(tools)) if os.path.isdir(tools) else ():
        path = os.path.join(tools, name)
        if name.endswith(".py") and _imports_port(path):
            out.append(path)
    return out


def _imports_port(path: str) -> bool:
    with open(path, encoding="utf-8") as f:
        try:
            tree = ast.parse(f.read(), filename=path)
        except SyntaxError:
            return False
    for node in _walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        if any(m.split(".")[0] in ("torch", "deeplearning4j_tpu_torch")
               for m in mods):
            return True
    return False
