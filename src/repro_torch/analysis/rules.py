"""The AST lint rules — the pluggable half of ``repro_torch.analysis``.

The counterpart of ``repro/analysis/rules.py``. Each rule is a function
``fn(ctx: ModuleContext) -> Iterator[Finding]`` registered under a stable ID
(``HOST-SYNC``, …); which functions are hot, and which local names hold
tensors, is worked out once per module by :func:`build_context` and shared
by every rule.

What "hot" means. The reference keys on JAX trace entry points (``jax.jit``,
``lax.scan``, …), which eager torch has none of. The port's hot steps — the
code that runs once per env step, update or decoded token, where a host
sync stalls the card — are named instead in an explicit table,
``analysis/targets.py::HOT_STEPS`` (module path → function qualnames); a
caller may pass its own set (``check_source(hot=…)``, as the conformance
harness does for an env class). A function is hot when it

  * is named in that table or set (a method by ``Class.method``, a nested
    function by ``outer.inner``),
  * is lexically nested inside a hot function, or
  * is a module-level or nested function a hot function calls by bare name
    (transitively).

A table entry that names no function of its module is itself a finding
(``STALE-HOT-STEP``), so a rename cannot shrink coverage quietly.

Within a hot function the *parameters* are assumed to be tensors
(``self``/``cls`` and parameters annotated ``int``, ``float``, ``bool``,
``str``, ``bytes`` or ``…Config`` excluded) and taint propagates through
simple assignments. Uses that are static on a tensor — ``x.shape``,
``x.dtype``, ``len(x)``, ``isinstance(x, …)``, ``x is None`` — never count.

The reference's TRACER-BRANCH folds into HOST-SYNC (a Python branch on a
tensor is a host sync in eager torch); DONATION-REUSE (no buffer donation)
and IMPURE-IMPORT (host numpy inside a trace) have no eager counterpart.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# findings + registry

@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def key(self) -> tuple:
        """Line-number-insensitive identity used by the baseline file: a
        finding survives unrelated edits above it."""
        return (self.path, self.rule, " ".join(self.snippet.split()))

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    fn: Callable


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, summary: str):
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, summary, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# module context

# attribute reads that are static on a tensor — never taint evidence
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "requires_grad", "itemsize", "num_agents", "horizon"}
STATIC_METHODS = {"dim", "size", "numel", "element_size", "is_contiguous",
                  "stride", "storage_offset", "is_floating_point",
                  "data_ptr", "get_device"}
# calls whose result is a host value regardless of tensor args
STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "id",
                "repr", "str"}

_NONDET_ROOTS = {"time", "random", "datetime", "secrets", "uuid"}
# torch draws that take a generator= (without it: the global stream)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli",
                "multinomial", "normal", "poisson", "rand_like",
                "randn_like", "randint_like"}
_TENSOR_DRAWS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                 "random_", "geometric_", "cauchy_", "log_normal_",
                 "multinomial", "bernoulli"}

_BLOCKING_GATE_IMPORTS = {"threading", "queue", "multiprocessing", "socket",
                          "concurrent", "concurrent.futures"}


@dataclass
class FuncInfo:
    node: ast.AST                # FunctionDef | AsyncFunctionDef | Lambda
    name: str
    qualname: str
    parent: Optional[ast.AST]          # enclosing function node or None
    hot: bool = False
    hot_reason: str = ""


@dataclass
class ModuleContext:
    path: str
    source: str
    lines: List[str]
    tree: ast.Module
    # id(node) -> its FuncInfo; id(node) -> its parent node
    funcs: Dict[int, FuncInfo] = field(default_factory=dict)
    parents: Dict[int, ast.AST] = field(default_factory=dict)
    # alias -> module; from-imported name -> module
    module_aliases: Dict[str, str] = field(default_factory=dict)
    from_imports: Dict[str, str] = field(default_factory=dict)
    has_threading_imports: bool = False
    missing_hot: List[str] = field(default_factory=list)  # stale table names

    # -- helpers shared by rules --------------------------------------------

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = self.lines[line - 1].strip() if line <= len(self.lines) \
            else ""
        return Finding(rule_id, self.path, line, col, message, snippet)

    def hot_funcs(self) -> List[FuncInfo]:
        return [fi for fi in self.funcs.values() if fi.hot]


def dotted_chain(node: ast.AST) -> Tuple[str, ...]:
    """``torch.cuda.synchronize`` → ("torch", "cuda", "synchronize"); () if
    not a name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def body_stmts(fn_node: ast.AST) -> Iterator[ast.AST]:
    """All nodes of a function body, NOT descending into nested function
    definitions (those are checked on their own)."""
    if isinstance(fn_node, ast.Lambda):
        yield from ast.walk(fn_node.body)
        return
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# annotations that declare a parameter to be a host value, not a tensor
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}


def _annotated_host(p: ast.arg) -> bool:
    ann = p.annotation
    ch = dotted_chain(ann) if ann is not None else ()
    if not ch and isinstance(ann, ast.Constant) and \
            isinstance(ann.value, str):           # string annotation
        ch = tuple(ann.value.split("."))
    return bool(ch) and (ch[-1] in _HOST_ANNOTATIONS
                         or ch[-1].endswith("Config"))


def _param_names(fn_node: ast.AST) -> Set[str]:
    a = fn_node.args
    params = list(getattr(a, "posonlyargs", [])) + a.args + a.kwonlyargs
    names = [p.arg for p in params if not _annotated_host(p)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


def build_context(tree: ast.Module, source: str, path: str,
                  hot: Optional[Set[str]] = None) -> ModuleContext:
    """``hot``: the qualnames of this module's hot steps (None: none)."""
    ctx = ModuleContext(path=path, source=source,
                        lines=source.splitlines(), tree=tree)

    # parent map + function table; classes and functions both qualify names
    func_stack: List[ast.AST] = []

    def visit(node, parent, qual):
        ctx.parents[id(node)] = parent
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            name = getattr(node, "name", "<lambda>")
            qn = f"{qual}.{name}" if qual else name
            ctx.funcs[id(node)] = FuncInfo(
                node, name, qn, func_stack[-1] if func_stack else None)
            func_stack.append(node)
            for child in ast.iter_child_nodes(node):
                visit(child, node, qn)
            func_stack.pop()
        elif isinstance(node, ast.ClassDef):
            qn = f"{qual}.{node.name}" if qual else node.name
            for child in ast.iter_child_nodes(node):
                visit(child, node, qn)
        else:
            for child in ast.iter_child_nodes(node):
                visit(child, node, qual)

    for top in tree.body:
        visit(top, tree, "")

    # imports
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                ctx.module_aliases[al.asname or al.name.split(".")[0]] = \
                    al.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for al in node.names:
                ctx.from_imports[al.asname or al.name] = node.module
    mods = ({m.split(".")[0] for m in ctx.module_aliases.values()}
            | set(ctx.module_aliases.values())
            | {m.split(".")[0] for m in ctx.from_imports.values()})
    ctx.has_threading_imports = bool(mods & _BLOCKING_GATE_IMPORTS)

    def mark(fi: FuncInfo, reason: str):
        if not fi.hot:
            fi.hot, fi.hot_reason = True, reason

    by_qual = {fi.qualname: fi for fi in ctx.funcs.values()}
    for qn in sorted(hot or ()):
        if qn in by_qual:
            mark(by_qual[qn], "a hot step")
        else:
            ctx.missing_hot.append(qn)

    # propagate: lexical nesting + bare-name calls, to fixpoint. A bare name
    # resolves to the functions of that name visible from the caller: its
    # own nested ones and the module-level ones (not other classes' methods)
    visible: Dict[str, List[FuncInfo]] = {}
    for fi in ctx.funcs.values():
        par = ctx.parents.get(id(fi.node))
        if isinstance(par, ast.Module) or fi.parent is not None:
            visible.setdefault(fi.name, []).append(fi)
    changed = True
    while changed:
        changed = False
        for fi in ctx.funcs.values():
            if not fi.hot and fi.parent is not None and \
                    ctx.funcs[id(fi.parent)].hot:
                mark(fi, f"nested in hot {ctx.funcs[id(fi.parent)].qualname}")
                changed = True
        for fi in ctx.hot_funcs():
            for node in body_stmts(fi.node):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name):
                    for callee in visible.get(node.func.id, []):
                        if not callee.hot:
                            mark(callee, f"called from hot {fi.qualname}")
                            changed = True
    return ctx


# ---------------------------------------------------------------------------
# taint: which local names hold tensors inside a hot function

def _assign_targets(node) -> List[str]:
    out = []

    def grab(t):
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                grab(el)
        elif isinstance(t, ast.Starred):
            grab(t.value)
    if isinstance(node, ast.Assign):
        for t in node.targets:
            grab(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        grab(node.target)
    elif isinstance(node, ast.For):
        grab(node.target)
    elif isinstance(node, ast.withitem) and node.optional_vars is not None:
        grab(node.optional_vars)
    return out


def hot_names(expr: ast.AST, tainted: Set[str]) -> Set[str]:
    """Tainted names used *non-statically* in ``expr``: a name only read
    through ``.shape``/``.dtype``/``len()``/``isinstance()``/``is None``
    does not count."""
    found: Set[str] = set()

    def walk(node):
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            return                      # x.shape, x.dtype, ... — static
        if isinstance(node, ast.Compare) and node.ops and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return                      # identity: never reads the data
        if isinstance(node, ast.Compare) and node.ops and \
                all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str):
            return                      # '"key" in batch' — structural
        if isinstance(node, ast.Call):
            ch = dotted_chain(node.func)
            if ch and ch[-1] in STATIC_CALLS:
                return                  # len(x), isinstance(x, T), ...
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in STATIC_METHODS:
                return                  # x.dim(), x.size(0), ...
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in tainted:
            found.add(node.id)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(expr)
    return found


def taint_of(fn_node: ast.AST) -> Set[str]:
    """Names holding (things derived from) the function's parameters."""
    tainted = set(_param_names(fn_node))
    changed = True
    while changed:
        changed = False
        for node in body_stmts(fn_node):
            value = None
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = node.value
            elif isinstance(node, ast.For):
                value = node.iter
            if value is None:
                continue
            if hot_names(value, tainted):
                for name in _assign_targets(node):
                    if name not in tainted:
                        tainted.add(name)
                        changed = True
    return tainted


# ---------------------------------------------------------------------------
# the rules

@rule("STALE-HOT-STEP",
      "a hot-step table entry names no function of its module")
def _stale_hot_step(ctx: ModuleContext) -> Iterator[Finding]:
    for qn in ctx.missing_hot:
        yield Finding("STALE-HOT-STEP", ctx.path, 1, 0,
                      f"the hot-step table names '{qn}', which this module "
                      f"does not define — the lint no longer covers it; "
                      f"update analysis/targets.py::HOT_STEPS",
                      f"HOT_STEPS {qn}")


_SYNC_ATTRS = {"item", "tolist", "numpy", "cpu"}


@rule("HOST-SYNC",
      "host sync (.item()/.cpu()/.tolist()/.numpy(), float()/int()/bool() "
      "or a branch on a tensor, torch.cuda.synchronize) in a hot step")
def _host_sync(ctx: ModuleContext) -> Iterator[Finding]:
    for fi in ctx.hot_funcs():
        tainted = taint_of(fi.node)
        for node in body_stmts(fi.node):
            kind, hot = None, set()
            if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                hot = hot_names(node.test, tainted)
                kind = ("conditional expression" if isinstance(node, ast.IfExp)
                        else type(node).__name__.lower())
                kind = f"a Python {kind} on"
            elif isinstance(node, ast.Call):
                ch = dotted_chain(node.func)
                if ch and len(ch) == 1 and ch[0] in ("float", "int", "bool",
                                                     "complex"):
                    for a in node.args:
                        hot |= hot_names(a, tainted)
                    kind = f"{ch[0]}() of"
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_ATTRS and not node.args:
                    hot = hot_names(node.func.value, tainted) or {"?"}
                    kind = f".{node.func.attr}() of"
                elif ch[-2:] == ("cuda", "synchronize") or \
                        ch[-1:] == ("synchronize",) and \
                        ctx.from_imports.get("synchronize", "") == \
                        "torch.cuda":
                    hot, kind = {"the device"}, "a synchronize of"
                elif ch and len(ch) >= 2 and ch[-1] in ("asarray", "array") \
                        and ctx.module_aliases.get(ch[0]) == "numpy":
                    for a in node.args:
                        hot |= hot_names(a, tainted)
                    kind = f"{'.'.join(ch)}() of"
            if hot and kind:
                yield ctx.finding(
                    "HOST-SYNC", node,
                    f"{kind} {sorted(hot)} inside hot step '{fi.qualname}' "
                    f"({fi.hot_reason}) — the host waits for the card here "
                    f"every step; keep the value on the device "
                    f"(torch.where, a masked op) or move it out of the step")


_PORT_BLOCKING_CALLS = {"spin_until", "wait_fragments"}


@rule("BLOCKING-NO-TIMEOUT",
      "blocking queue/thread call without a timeout in threaded code")
def _blocking_no_timeout(ctx: ModuleContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        kwnames = {kw.arg for kw in node.keywords}
        if "timeout" in kwnames:
            continue
        # this repo's own cross-process waits (shm.spin_until, the async
        # tier's AsyncRollouts.wait_fragments) declare timeout kw-only for
        # exactly this reason — a call without it spins forever on a dead
        # peer. Checked regardless of the import gate.
        fname = (node.func.id if isinstance(node.func, ast.Name)
                 else node.func.attr if isinstance(node.func, ast.Attribute)
                 else None)
        if fname in _PORT_BLOCKING_CALLS:
            yield ctx.finding(
                "BLOCKING-NO-TIMEOUT", node,
                f"{fname}() without timeout= — this wait spins on another "
                f"process's progress (actor/learner slab handshake); a "
                f"dead peer turns it into a livelock. The timeout turns "
                f"that into a diagnosable error")
            continue
        if not ctx.has_threading_imports:
            continue
        # bare `wait(object_list)` from-imported from
        # multiprocessing.connection — blocks until a connection is ready
        if (isinstance(node.func, ast.Name) and node.func.id == "wait"
                and node.args
                and ctx.from_imports.get("wait", "").endswith("connection")):
            yield ctx.finding(
                "BLOCKING-NO-TIMEOUT", node,
                "connection.wait(objects) without a timeout — a dead or "
                "wedged peer turns this into a silent deadlock; pass "
                "timeout= (poll in a loop if cancellation must be honored)")
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        blocking = False
        if attr == "get" and not node.args:
            # Queue.get() — dict.get always takes >= 1 positional arg
            blocking = not any(kw.arg == "block" and
                               isinstance(kw.value, ast.Constant) and
                               kw.value.value is False
                               for kw in node.keywords)
        elif attr == "join" and not node.args:
            # Thread/Process.join() — str.join always takes an argument
            blocking = True
        elif attr in ("recv", "result") and not node.args:
            blocking = True
        elif attr in ("acquire", "wait") and not node.args:
            blocking = not any(kw.arg == "blocking" and
                               isinstance(kw.value, ast.Constant) and
                               kw.value.value is False
                               for kw in node.keywords)
        elif attr == "wait" and node.args:
            # connection.wait(object_list): the positional arg is the
            # object list, not a timeout (unlike Event.wait(t))
            ch = dotted_chain(node.func)
            blocking = len(ch) >= 2 and ch[-2] == "connection"
        elif attr == "accept" and not node.args:
            # socket.accept() parks the thread until a client connects
            blocking = True
        elif attr == "serve_forever":
            # blocks until shutdown() from another thread
            blocking = True
        if blocking:
            yield ctx.finding(
                "BLOCKING-NO-TIMEOUT", node,
                f".{attr}() without a timeout in a module that uses "
                f"threads/queues — a dead or wedged peer turns this into "
                f"a silent deadlock; pass timeout= (poll in a loop if "
                f"cancellation must be honored)")


@rule("NONDET-IN-PURE",
      "time/random/uuid, or a torch draw without generator=, in a hot step")
def _nondet_in_pure(ctx: ModuleContext) -> Iterator[Finding]:
    for fi in ctx.hot_funcs():
        for node in body_stmts(fi.node):
            if not isinstance(node, ast.Call):
                continue
            ch = dotted_chain(node.func)
            root_mod = ctx.module_aliases.get(ch[0]) if ch else None
            bad = None
            if len(ch) >= 2 and root_mod in _NONDET_ROOTS:
                bad = f"{root_mod}.{'.'.join(ch[1:])}()"
            elif len(ch) >= 2 and root_mod == "numpy" and ch[1] == "random":
                bad = f"numpy.{'.'.join(ch[1:])}()"
            elif ch and root_mod is None and ctx.from_imports.get(
                    ch[0], "").split(".")[0] in _NONDET_ROOTS:
                bad = f"{'.'.join(ch)}()"
            elif "generator" not in {kw.arg for kw in node.keywords}:
                if len(ch) == 2 and root_mod == "torch" and \
                        ch[1] in _TORCH_DRAWS:
                    bad = f"torch.{ch[1]}() without generator="
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _TENSOR_DRAWS and \
                        ctx.module_aliases.get(ch[0] if ch else "") != \
                        "torch":
                    bad = f".{node.func.attr}() without generator="
            if bad:
                yield ctx.finding(
                    "NONDET-IN-PURE", node,
                    f"{bad} inside hot step '{fi.qualname}' "
                    f"({fi.hot_reason}) — the step stops being a function "
                    f"of (state, action, generator): seeded runs diverge; "
                    f"draw from the generator the step is given")


_TELEMETRY_MOD = "repro_torch.telemetry"


@rule("TELEMETRY-IN-HOT",
      "telemetry span/registry/timer call inside a hot step")
def _telemetry_in_hot(ctx: ModuleContext) -> Iterator[Finding]:
    """Spans and metric updates are host-side work: inside a per-step hot
    function they run once a step, on the path the card waits on. Telemetry
    belongs around the launch, never inside the step."""

    def telemetry_source(ch: Tuple[str, ...]) -> Optional[str]:
        if not ch:
            return None
        root = ch[0]
        mod = ctx.module_aliases.get(root)
        if mod is not None and (mod == _TELEMETRY_MOD or
                                mod.startswith(_TELEMETRY_MOD + ".")):
            return mod
        src = ctx.from_imports.get(root, "")
        if root == "telemetry" and src == "repro_torch":
            return _TELEMETRY_MOD          # from repro_torch import telemetry
        if src == _TELEMETRY_MOD or src.startswith(_TELEMETRY_MOD + "."):
            return src
        return None

    for fi in ctx.hot_funcs():
        for node in body_stmts(fi.node):
            if not isinstance(node, ast.Call):
                continue
            ch = dotted_chain(node.func)
            src = telemetry_source(ch)
            if src:
                yield ctx.finding(
                    "TELEMETRY-IN-HOT", node,
                    f"telemetry call {'.'.join(ch)}() (from {src}) inside "
                    f"hot step '{fi.qualname}' ({fi.hot_reason}) — move "
                    f"the instrumentation to the host side of the launch")
