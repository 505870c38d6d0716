"""Lock-discipline linter: `guarded-by` annotations, checked by AST (the
port's copy of paddle_tpu/analysis/lock_lint.py, pointed at the port's
threaded modules).

The threaded subsystems (distributed/ supervisor+coordinator, data/
loader, serving/ engine) repeatedly grew the same review findings:
a field the coordinator lock protects mutated on a path that forgot
`with self._lock:`, or two locks taken in opposite orders on two paths.
This pass turns the convention into code:

  self._lock = threading.Lock()
  self.todo = []          # guarded-by: _lock
  self._pos = 0           # guarded-by: consumer

* A guard that names a lock attribute of the class (assigned from
  `threading.Lock/RLock/Condition/Semaphore`) demands every mutation of
  the guarded attribute happen lexically under `with self.<lock>:` —
  or inside a method whose call sites all hold it (inferred through the
  same-class call graph), or one annotated `def m(self): # holds: _lock`
  (caller contract). `__init__` (and helpers only it calls) is
  construction — exempt.
* Any other guard names a thread-confinement DOMAIN. Methods declare
  their domain with `def _produce(self): # thread: producer`; mutating
  an attribute guarded by domain D inside a method declared to run on a
  different domain is a finding; a private undeclared method called
  EXCLUSIVELY from one domain's methods inherits that domain (the same
  call-site inference locks get). Otherwise-undeclared methods are
  assumed to run on the owning domain — the check is about catching
  the annotated producer/consumer split drifting, with zero noise
  elsewhere.

Codes:
  L001 unguarded-mutation     guarded attribute mutated outside its
                              lock scope / on the wrong thread domain
  L002 lock-order-inversion   cycle in the lock-acquisition graph
                              (lexical nesting + same-class calls)
  L003 wait-outside-while     `Condition.wait()` not lexically inside a
                              `while` loop: a notify is not a promise
                              the predicate holds (spurious wakeups,
                              stolen wakeups, notify_all storms) —
                              `wait_for()` loops internally and is
                              exempt
  L004 notify-outside-lock    `notify()/notify_all()` on a Condition
                              whose lock is not held at the call site:
                              the runtime raises for this, but only on
                              the path that reaches it — the linter
                              finds the path first
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, make, rel_path, walk_python_files

__all__ = ["lint_file", "lint_paths", "DEFAULT_PATHS"]

# every threaded module of the port that carries `# guarded-by:`
# annotations (the JAX package's three directories, plus the trip
# detector and the schedule explorer's controller)
DEFAULT_PATHS = [
    "paddle_tpu_torch/distributed",
    "paddle_tpu_torch/data",
    "paddle_tpu_torch/serving",
    "paddle_tpu_torch/utils/detector.py",
    "paddle_tpu_torch/analysis/sched_explore.py",
]

# the value must START with a word char: a placeholder like
# `# guarded-by: <lock>` (docs template) must not parse as a guard
_ANNOT_RE = re.compile(
    r"#\s*(guarded-by|holds|thread)\s*:\s*([\w.\-][\w.,\- ]*)")
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft",
    "appendleft", "extendleft", "clear", "add", "discard", "update",
    "setdefault", "popitem", "sort", "reverse", "rotate",
}
# Condition-discipline ops (L003/L004). `wait_for` is recorded but
# never L003-flagged: it re-evaluates its predicate internally.
_COND_OPS = {"wait", "wait_for", "notify", "notify_all"}

# sentinel context: "only construction has reached this method"
_EXEMPT = "exempt"
# sentinel context: "no information yet" (fixpoint top element)
_TOP = "top"


def _line_annotations(src: str) -> Dict[int, List[Tuple[str, str]]]:
    out: Dict[int, List[Tuple[str, str]]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        for m in _ANNOT_RE.finditer(line):
            out.setdefault(i, []).append((m.group(1), m.group(2).strip()))
    return out


def _self_attr(node) -> Optional[str]:
    """`self.X` -> "X" (also the base of `self.X[k]` / `self.X[k].y`)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


class _Method(object):
    def __init__(self, node, cls_name):
        self.node = node
        self.name = node.name
        self.symbol = "%s.%s" % (cls_name, node.name)
        self.holds: Set[str] = set()     # holds: annotation
        self.domain: Optional[str] = None  # thread: annotation
        # declared domain, or the one inferred from call sites (a
        # private helper called only from producer-declared methods
        # runs on the producer thread too)
        self.eff_domain: Optional[str] = None
        # (attr, lineno, frozenset(held locks at the mutation))
        self.mutations: List[Tuple[str, int, FrozenSet[str]]] = []
        # (lock, lineno, frozenset(held locks BEFORE acquiring))
        self.acquisitions: List[Tuple[str, int, FrozenSet[str]]] = []
        # (callee, lineno, frozenset(held locks at the call))
        self.calls: List[Tuple[str, int, FrozenSet[str]]] = []
        # Condition-discipline sites: (cond attr, op, lineno,
        # frozenset(held locks), lexically-inside-a-while)
        self.cond_calls: List[Tuple[str, str, int, FrozenSet[str],
                                    bool]] = []
        self.context = _TOP  # fixpoint: _TOP -> _EXEMPT | frozenset


class _Class(object):
    def __init__(self, node):
        self.node = node
        self.name = node.name
        self.locks: Set[str] = set()
        # Condition attr -> the lock that must be held to wait/notify
        # on it: itself, or the explicit `threading.Condition(self.X)`
        # lock argument
        self.conditions: Dict[str, str] = {}
        self.guards: Dict[str, str] = {}   # attr -> guard name
        self.guard_lines: Dict[str, int] = {}
        self.methods: Dict[str, _Method] = {}


def _collect_class(node: ast.ClassDef, annots) -> _Class:
    cls = _Class(node)
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        meth = _Method(item, cls.name)
        cls.methods[item.name] = meth
        body_start = item.body[0].lineno if item.body else item.lineno
        for ln in range(item.lineno, body_start + 1):
            for kind, val in annots.get(ln, ()):
                if kind == "holds":
                    meth.holds.update(
                        v.strip().split()[0] for v in val.split(",")
                        if v.strip())
                elif kind == "thread":
                    toks = val.split(",")[0].split()
                    if toks:
                        meth.domain = toks[0]
        _scan_method_decls(cls, meth, annots)
    for meth in cls.methods.values():
        _scan_method_body(cls, meth)
    return cls


def _scan_method_decls(cls: _Class, meth: _Method, annots):
    """Lock attrs + guarded-attr declarations (any method may declare,
    __init__ in practice)."""
    for node in ast.walk(meth.node):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            value = node.value
            for t in targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if (isinstance(value, ast.Call)
                        and isinstance(value.func, (ast.Attribute,
                                                    ast.Name))):
                    fname = (value.func.attr
                             if isinstance(value.func, ast.Attribute)
                             else value.func.id)
                    if fname in _LOCK_CTORS:
                        cls.locks.add(attr)
                    if fname == "Condition":
                        lock_arg = (value.args[0] if value.args
                                    else None)
                        for kw in value.keywords:
                            if kw.arg == "lock":
                                lock_arg = kw.value
                        explicit = (_self_attr(lock_arg)
                                    if lock_arg is not None else None)
                        cls.conditions[attr] = explicit or attr
                end = getattr(node, "end_lineno", node.lineno)
                for ln in range(node.lineno, end + 1):
                    for kind, val in annots.get(ln, ()):
                        if kind == "guarded-by":
                            toks = val.split(",")[0].split()
                            if toks:
                                cls.guards[attr] = toks[0]
                                cls.guard_lines.setdefault(attr, ln)


def _scan_method_body(cls: _Class, meth: _Method):
    # suite carriers whose nested statements do_stmt walks itself —
    # scan_exprs must not blind-walk them with the OUTER held-set
    suite_nodes = (ast.stmt, ast.excepthandler)
    if hasattr(ast, "match_case"):
        suite_nodes += (ast.match_case,)

    def scan_exprs(stmt, held, in_while=False):
        """Calls (mutator methods + same-class self.m() + Condition
        wait/notify ops) in the statement's OWN expressions — child
        statement suites (including except handlers and match cases)
        are walked by do_stmt with their own held sets. A lambda body
        is DEFERRED execution: it cannot assume the caller's locks, so
        its mutations record with an empty held-set (a
        `pool.submit(lambda: self.q.append(x))` under the lock still
        runs lockless later)."""
        for _name, value in ast.iter_fields(stmt):
            values = value if isinstance(value, list) else [value]
            for v in values:
                if not isinstance(v, ast.AST) or isinstance(
                        v, suite_nodes):
                    continue
                stack = [(v, held)]
                while stack:
                    sub, h = stack.pop()
                    if isinstance(sub, ast.Lambda):
                        h = frozenset()
                    for c in ast.iter_child_nodes(sub):
                        stack.append((c, h))
                    if not isinstance(sub, ast.Call):
                        continue
                    func = sub.func
                    if not isinstance(func, ast.Attribute):
                        continue
                    base_attr = _self_attr(func.value)
                    if base_attr is not None and func.attr in _MUTATORS:
                        meth.mutations.append(
                            (base_attr, sub.lineno, h))
                    if base_attr is not None and func.attr in _COND_OPS:
                        meth.cond_calls.append(
                            (base_attr, func.attr, sub.lineno, h,
                             in_while))
                    if (isinstance(func.value, ast.Name)
                            and func.value.id == "self"
                            and func.attr in cls.methods):
                        meth.calls.append((func.attr, sub.lineno, h))

    def do_stmt(node, held: FrozenSet[str], in_while: bool = False):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs: out of scope for this pass
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            scan_exprs(node, held, in_while)
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in cls.locks:
                    meth.acquisitions.append(
                        (attr, node.lineno, frozenset(inner)))
                    inner.add(attr)
            for s in node.body:
                do_stmt(s, frozenset(inner), in_while)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                _record_mut(cls, meth, t, node.lineno, held)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            # a bare annotation (`self.x: T` with no value) declares,
            # it does not mutate
            if not (isinstance(node, ast.AnnAssign)
                    and node.value is None):
                _record_mut(cls, meth, node.target, node.lineno, held)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                _record_mut(cls, meth, t, node.lineno, held)
        # a While's test AND body both re-run per iteration: a wait()
        # anywhere under it gets its predicate re-checked (the
        # `while True: ... if p: break ... wait()` idiom included);
        # the else: suite runs once, after the loop — not re-checked
        here = in_while or isinstance(node, ast.While)
        scan_exprs(node, held, here)
        for fname, value in ast.iter_fields(node):
            # a While's own body re-runs per iteration; its else:
            # suite runs once after the loop — but inherits any OUTER
            # while's re-run context
            suite_while = in_while or (
                isinstance(node, ast.While) and fname != "orelse")
            values = value if isinstance(value, list) else [value]
            for v in values:
                if isinstance(v, ast.stmt):
                    do_stmt(v, held, suite_while)
                elif isinstance(v, suite_nodes):
                    # except handlers / match cases: their OWN
                    # expressions (case guard/pattern, except type)
                    # scan here; their bodies are statement suites
                    # under the same held-set
                    scan_exprs(v, held, suite_while)
                    for s in getattr(v, "body", ()):
                        do_stmt(s, held, suite_while)

    for s in meth.node.body:
        do_stmt(s, frozenset())


def _record_mut(cls, meth, target, lineno, held):
    if isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            _record_mut(cls, meth, el, lineno, held)
        return
    attr = _self_attr(target)
    if attr is not None:
        meth.mutations.append((attr, lineno, held))


# --- call-context inference -------------------------------------------

def _infer_contexts(cls: _Class):
    """Fixpoint: which locks is a method's body guaranteed to run
    under? __init__ is construction (exempt); public methods assume an
    unguarded external caller; private methods inherit the
    INTERSECTION of their observed same-class call sites."""
    callers: Dict[str, List[Tuple[_Method, FrozenSet[str]]]] = {
        name: [] for name in cls.methods
    }
    for meth in cls.methods.values():
        for callee, _ln, held in meth.calls:
            callers[callee].append((meth, held))

    for name, meth in cls.methods.items():
        if name == "__init__":
            meth.context = _EXEMPT
        elif not name.startswith("_") or (
                name.startswith("__") and name.endswith("__")):
            meth.context = frozenset(meth.holds)
        else:
            meth.context = _TOP

    for _ in range(len(cls.methods) + 2):
        changed = False
        for name, meth in cls.methods.items():
            if name == "__init__" or not name.startswith("_") or (
                    name.startswith("__") and name.endswith("__")):
                continue
            sites = callers[name]
            if not sites:
                new = frozenset(meth.holds)
            else:
                lock_sets = []
                all_exempt = True
                unresolved = False
                for caller, held in sites:
                    if caller.context == _TOP:
                        unresolved = True
                        continue
                    if caller.context == _EXEMPT:
                        continue
                    all_exempt = False
                    lock_sets.append(frozenset(caller.context) | held)
                if unresolved and not lock_sets:
                    continue  # wait for callers to resolve
                if all_exempt and not lock_sets:
                    new = _EXEMPT
                else:
                    inter = lock_sets[0]
                    for s in lock_sets[1:]:
                        inter &= s
                    new = inter | frozenset(meth.holds)
            if new != meth.context:
                meth.context = new
                changed = True
        if not changed:
            break
    for meth in cls.methods.values():
        if meth.context == _TOP:  # recursion-only cluster: conservative
            meth.context = frozenset(meth.holds)

    # thread-domain inference mirrors the lock inference: a private
    # undeclared method called EXCLUSIVELY from methods of one domain
    # inherits it; mixed or unknown callers leave it unchecked (no
    # false positives — the inline num_workers==0 path legitimately
    # runs producer code on the consumer thread).
    for meth in cls.methods.values():
        meth.eff_domain = meth.domain
    for _ in range(len(cls.methods) + 1):
        changed = False
        for name, meth in cls.methods.items():
            if (meth.domain is not None or name == "__init__"
                    or not name.startswith("_")
                    or (name.startswith("__") and name.endswith("__"))):
                continue
            sites = [c for c, _held in callers[name]
                     if c.name != "__init__"]
            if not sites:
                continue
            doms = {c.eff_domain for c in sites}
            new = doms.pop() if len(doms) == 1 else None
            if new is not None and meth.eff_domain != new:
                meth.eff_domain = new
                changed = True
        if not changed:
            break


# --- checks ------------------------------------------------------------

def _check_class(cls: _Class, path: str, diags: List[Diagnostic]):
    if not cls.guards and not cls.locks:
        return
    _infer_contexts(cls)

    for meth in cls.methods.values():
        if meth.name == "__init__" or meth.context == _EXEMPT:
            continue
        assumed = meth.context if isinstance(meth.context, frozenset) \
            else frozenset()
        for attr, lineno, held in meth.mutations:
            guard = cls.guards.get(attr)
            if guard is None:
                continue
            if guard in cls.locks:
                if guard not in (held | assumed):
                    diags.append(make(
                        "L001", path, lineno, meth.symbol, attr,
                        "%r is guarded by lock %r but mutated without "
                        "holding it (held here: %s)"
                        % (attr, guard,
                           sorted(held | assumed) or "nothing")))
            else:
                dom = meth.eff_domain
                if dom is not None and dom != guard:
                    how = ("declared" if meth.domain is not None
                           else "inferred (from its callers) as")
                    diags.append(make(
                        "L001", path, lineno, meth.symbol, attr,
                        "%r is confined to the %r domain but mutated "
                        "in a method %s '# thread: %s'"
                        % (attr, guard, how, dom)))

        for attr, op, lineno, held, in_while in meth.cond_calls:
            owner = cls.conditions.get(attr)
            if owner is None:
                continue  # .wait()/.notify() on a non-Condition attr
            if op == "wait" and not in_while:
                diags.append(make(
                    "L003", path, lineno, meth.symbol, attr,
                    "%r.wait() outside a while-predicate loop: a "
                    "notify is not a promise the predicate holds "
                    "(spurious/stolen wakeups) — re-test in a while, "
                    "or use wait_for()" % attr))
            # holding the Condition ITSELF counts: `with self._cv:`
            # acquires the (possibly explicit) lock it wraps
            if op in ("notify", "notify_all") \
                    and not ({owner, attr} & (held | assumed)):
                diags.append(make(
                    "L004", path, lineno, meth.symbol, attr,
                    "%r.%s() without holding %r (held here: %s): the "
                    "runtime raises RuntimeError on whichever path "
                    "reaches this first"
                    % (attr, op, owner,
                       sorted(held | assumed) or "nothing")))

    _check_lock_order(cls, path, diags)


def _acquires_closure(cls: _Class) -> Dict[str, Set[str]]:
    acq = {name: {a for a, _, _ in m.acquisitions}
           for name, m in cls.methods.items()}
    for _ in range(len(cls.methods) + 1):
        changed = False
        for name, meth in cls.methods.items():
            for callee, _ln, _held in meth.calls:
                extra = acq.get(callee, set()) - acq[name]
                if extra:
                    acq[name] |= extra
                    changed = True
        if not changed:
            break
    return acq


def _check_lock_order(cls: _Class, path: str, diags: List[Diagnostic]):
    if len(cls.locks) < 2:
        return
    edges: Dict[str, Set[str]] = {}
    first_line: Dict[Tuple[str, str], int] = {}

    def add_edge(a, b, ln):
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        first_line.setdefault((a, b), ln)

    acq_closure = _acquires_closure(cls)
    for meth in cls.methods.values():
        assumed = meth.context if isinstance(meth.context, frozenset) \
            else frozenset()
        for lock, ln, held in meth.acquisitions:
            for a in held | assumed | frozenset(meth.holds):
                add_edge(a, lock, ln)
        for callee, ln, held in meth.calls:
            for b in acq_closure.get(callee, ()):
                for a in held | assumed | frozenset(meth.holds):
                    add_edge(a, b, ln)

    # cycle detection (DFS); report each cycle once by its sorted key
    reported = set()

    def dfs(start, node, stack, seen):
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                key = tuple(sorted(stack))
                if key not in reported:
                    reported.add(key)
                    order = stack + [start]
                    diags.append(make(
                        "L002", path,
                        first_line.get((order[0], order[1]),
                                       cls.node.lineno),
                        cls.name, "->".join(key),
                        "lock-order inversion: %s — two paths acquire "
                        "these locks in opposite orders (deadlock risk)"
                        % " -> ".join(order)))
            elif nxt not in seen:
                dfs(start, nxt, stack + [nxt], seen | {nxt})

    for node in sorted(edges):
        dfs(node, node, [node], {node})


# --- entry points ------------------------------------------------------

def lint_file(path: str) -> List[Diagnostic]:
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    annots = _line_annotations(src)
    rel = rel_path(path)
    diags: List[Diagnostic] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            _check_class(_collect_class(node, annots), rel, diags)
    diags.sort(key=lambda d: (d.path, d.line, d.code))
    return diags


def lint_paths(paths=None) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for f in walk_python_files(paths, DEFAULT_PATHS):
        diags.extend(lint_file(f))
    return diags
