"""Sync-free hot-path linter: an AST pass over the port's dispatch paths
(the port's counterpart of paddle_tpu/analysis/trace_lint.py).

The JAX package lints the functions it traces: a host sync inside a
jitted step is a tracer error or a stall. An eager torch program has no
trace, so the port's roots are the functions its author declares
sync-free, with `# sync-free` on the `def` line (or the lines down to
the first body statement, the `# thread:` placement rule):

    def _launch_window(self, prev, live):  # sync-free

A root's nested defs and lambdas, and the functions of the same module
it calls by name, are linted with it (local call-graph propagation, as
the JAX lint propagates through local calls; `self.m()` and calls into
other modules are not resolved). Each root is one that `chip_smoke.py`
runs on the card under `torch.cuda.set_sync_debug_mode("error")`, so
the static claim and the card's check cover the same code.

  T001 host-sync-in-sync-free  `.item()`, `.tolist()`, `.cpu()`,
                            `.numpy()`, `.synchronize()`,
                            `torch.cuda.synchronize`, `.to("cpu")`,
                            `float()/int()/bool()` of a non-literal, or
                            `np.asarray/np.array/np.copy` of a value the
                            lint cannot show lies on the host — each
                            blocks the host until the card has caught up
  T002 unseeded-draw-in-sync-free  a host draw (`random.*`,
                            `np.random.*`), or a torch draw
                            (`torch.rand*`, `randint`, `randn`,
                            `normal`, `bernoulli`, `multinomial`,
                            `randperm`, and the in-place `.uniform_()` /
                            `.normal_()` / ...) with no explicit
                            `generator=` — the port's sampled paths draw
                            from seeded threefry counters so they match
                            the JAX package bit for bit; a global-RNG
                            draw breaks that parity
  T003 tensor-branch        `if`/`while` on a parameter of a root: on a
                            tensor that is an implicit `bool()`, a sync
                            (static accessors — `.shape`, `.ndim`,
                            `.dtype`, `.device`, `.size()`, `.dim()`,
                            `.numel()`, `len()`, `isinstance()`,
                            `is None` — a parameter annotated with a
                            host type, and `mapping.get("slot")`, the
                            test of an optional input slot, are exempt)
  T004                      no counterpart (`diagnostics.NO_COUNTERPART`):
                            the port has no jit cache
  T005 device-dispatch-in-scheduler  a `torch.` call that does device
                            work, reachable from a host-side scheduler
                            loop — a method annotated `# thread:
                            <domain>` (the fleet's replica and monitor
                            threads, the front door's readers, the load
                            generator) or any same-class method those
                            reach. A control thread that dispatches
                            device work per step serializes the fleet
                            behind one queue; device work belongs to
                            the engine's step (the context managers and
                            queries of `_HOST_TORCH` are host calls)

A value lies on the host, for T001's casts, numpy copies and readback
methods, when it is a literal, shape-level data (`x.shape[1]`,
`len(xs)`), a lookup with a literal default (`attrs.get("k", 0)`), a
numpy expression, a parameter or name annotated with a scalar or numpy
type (`live: np.ndarray`, `n: int`), an attribute its class assigns only
numpy arrays (the engine's host mirrors, `self._alive = np.zeros(...)`),
or a name assigned from one of these, or bound by a loop over one, in
the same function. An element of a list, dict or tuple is not host
data unless the container is: it may be a tensor.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, make, rel_path, walk_python_files

__all__ = ["lint_file", "lint_paths", "HOT_PATHS", "sync_free_roots"]

# the port's counterparts of the JAX package's hot paths, and the Fluid
# kernel module whose `lstm` op is a sync-free root; `--all` lints
# exactly these
HOT_PATHS = [
    "paddle_tpu_torch/models/transformer.py",
    "paddle_tpu_torch/parallel/paged_attention.py",
    "paddle_tpu_torch/serving/engine.py",
    "paddle_tpu_torch/serving/fleet.py",
    "paddle_tpu_torch/serving/tenancy.py",
    "paddle_tpu_torch/serving/adapters.py",
    "paddle_tpu_torch/serving/integrity.py",
    "paddle_tpu_torch/serving/kv_store.py",
    "paddle_tpu_torch/serving/quantization.py",
    "paddle_tpu_torch/serving/frontdoor.py",
    "paddle_tpu_torch/serving/loadgen.py",
    "paddle_tpu_torch/fluid/executor.py",
    "paddle_tpu_torch/fluid/core/lowering.py",
    "paddle_tpu_torch/fluid/core/kernels_rnn.py",
    "paddle_tpu_torch/distributed/sentinel.py",
]

_ROOT_RE = re.compile(r"#\s*sync-free\b")

_HOST_CAST_BUILTINS = {"float", "int", "bool", "complex"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_SYNC_CALLS = {"numpy.asarray", "numpy.array", "numpy.copy",
                    "torch.cuda.synchronize"}
_HOST_DRAW_PREFIXES = ("random.", "numpy.random.")
_TORCH_DRAWS = {"torch.rand", "torch.rand_like", "torch.randn",
                "torch.randn_like", "torch.randint", "torch.randint_like",
                "torch.normal", "torch.bernoulli", "torch.multinomial",
                "torch.randperm", "torch.poisson"}
_TORCH_DRAW_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                       "exponential_", "geometric_", "cauchy_",
                       "log_normal_", "multinomial", "bernoulli"}
_STATIC_ATTRS = {"ndim", "shape", "dtype", "device", "is_cuda",
                 "requires_grad", "layout", "axis_names"}
_STATIC_METHODS = {"size", "dim", "numel", "element_size",
                   "is_floating_point", "is_contiguous", "get_device"}
_SAFE_TEST_CALLS = {"len", "isinstance", "issubclass", "getattr",
                    "hasattr", "callable", "type", "numpy.ndim"}
# builtins whose result is host data when their arguments are (range's
# always is)
_HOST_BUILTINS = {"range", "enumerate", "zip", "min", "max", "abs",
                  "round", "sorted", "reversed", "str", "tuple", "list"}
# annotation names that declare a host value
# (a container's elements may be tensors: list, dict and tuple are not)
_HOST_TYPES = {"int", "float", "bool", "str", "bytes", "ndarray",
               "Optional"}
# torch calls a control thread may make: context managers, queries and
# handles, none of which enqueues device work
_HOST_TORCH = {
    "torch.device", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.set_grad_enabled", "torch.is_tensor",
    "torch.is_grad_enabled", "torch.get_num_threads",
    "torch.set_num_threads", "torch.cuda.device", "torch.cuda.stream",
    "torch.cuda.current_stream", "torch.cuda.current_device",
    "torch.cuda.set_device", "torch.cuda.is_available",
    "torch.cuda.device_count", "torch.cuda.get_device_name",
}


class _Fn(object):
    """One function/lambda scope."""

    def __init__(self, node, qualname: str, parent: Optional["_Fn"]):
        self.node = node
        self.qualname = qualname
        self.parent = parent
        self.children: Dict[str, "_Fn"] = {}  # name -> direct child def
        self.child_list: List["_Fn"] = []
        args = node.args
        self.params: Set[str] = {
            a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)
        }
        if args.vararg:
            self.params.add(args.vararg.arg)
        if args.kwarg:
            self.params.add(args.kwarg.arg)


class _ModuleIndex(ast.NodeVisitor):
    """Collect function scopes, the import alias table, and every call
    site paired with the scope it occurs in."""

    def __init__(self, tree):
        self.aliases: Dict[str, str] = {}
        self.module_fns: Dict[str, _Fn] = {}
        self.all_fns: List[_Fn] = []
        self.calls: List[Tuple[ast.Call, Optional[_Fn]]] = []
        self._stack: List[Optional[_Fn]] = [None]
        self.visit(tree)

    # imports ----------------------------------------------------------
    def visit_Import(self, node):
        for a in node.names:
            if a.asname:
                self.aliases[a.asname] = a.name
            else:
                self.aliases[a.name.split(".")[0]] = a.name.split(".")[0]

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        for a in node.names:
            self.aliases[a.asname or a.name] = (
                "%s.%s" % (mod, a.name) if mod else a.name)

    # scopes -----------------------------------------------------------
    def _enter(self, node, name):
        parent = self._stack[-1]
        qual = name if parent is None else "%s.%s" % (parent.qualname, name)
        fn = _Fn(node, qual, parent)
        if parent is None:
            self.module_fns.setdefault(name, fn)
        else:
            parent.children.setdefault(name, fn)
            parent.child_list.append(fn)
        self.all_fns.append(fn)
        self._stack.append(fn)
        return fn

    def visit_FunctionDef(self, node):
        self._enter(node, node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter(node, "<lambda>")
        self.generic_visit(node)
        self._stack.pop()

    def visit_ClassDef(self, node):
        # class bodies are not enclosing scopes for name resolution;
        # methods register under a shim carrying the class name
        parent = self._stack[-1]
        shim = _Fn(ast.Lambda(args=ast.arguments(
            posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[],
            defaults=[]), body=ast.Constant(value=None)),
            node.name if parent is None
            else "%s.%s" % (parent.qualname, node.name), parent)
        shim.is_class = True
        shim.host_attrs = _numpy_attrs(node)
        self._stack.append(shim)
        self.generic_visit(node)
        self._stack.pop()

    def visit_Call(self, node):
        self.calls.append((node, self._stack[-1]))
        self.generic_visit(node)


def _dotted(node, aliases) -> Tuple[Optional[str], bool]:
    """Resolve an expression to a dotted name with import aliases
    expanded. Returns (dotted, base_is_import): base_is_import is True
    only when the leftmost name is a known import alias — checks that
    must not fire on same-named locals require it."""
    parts = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None, False
    base = cur.id
    known = base in aliases
    parts.append(aliases.get(base, base))
    return ".".join(reversed(parts)), known


def _resolve(name: str, scope: Optional[_Fn], index: _ModuleIndex):
    """Find the function def `name` visible from `scope` under real
    Python scoping: class bodies (shim scopes) are NOT enclosing
    scopes."""
    s = scope
    while s is not None:
        if not getattr(s, "is_class", False) and name in s.children:
            return s.children[name]
        s = s.parent
    return index.module_fns.get(name)


def _own_stmt_nodes(fn_node):
    """Walk a def body without descending into nested defs/lambdas (or
    yielding them): they are functions of their own, and deferred work
    does not run at this call site."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _annotated(item, src_lines, pattern) -> Optional[re.Match]:
    body_start = item.body[0].lineno if item.body else item.lineno
    for ln in range(item.lineno, body_start + 1):
        if ln - 1 < len(src_lines):
            m = pattern.search(src_lines[ln - 1])
            if m:
                return m
    return None


# --- roots and propagation --------------------------------------------

def _root_fns(index: _ModuleIndex, src_lines) -> List[_Fn]:
    return [fn for fn in index.all_fns
            if isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and _annotated(fn.node, src_lines, _ROOT_RE) is not None]


def _linted_set(index: _ModuleIndex, roots: List[_Fn]) -> Set[_Fn]:
    """The roots, their nested defs and lambdas, and the same-module
    functions they call by name, to a fixpoint."""
    linted: Set[_Fn] = set()
    todo = list(roots)
    while todo:
        fn = todo.pop()
        if fn in linted:
            continue
        linted.add(fn)
        todo.extend(fn.child_list)
        for node in _own_stmt_nodes(fn.node):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                callee = _resolve(node.func.id, fn, index)
                if callee is not None:
                    todo.append(callee)
    return linted


def sync_free_roots(path: str) -> List[str]:
    """Qualified names of the `# sync-free` roots of one file."""
    with open(path) as f:
        src = f.read()
    index = _ModuleIndex(ast.parse(src, filename=path))
    return [fn.qualname for fn in _root_fns(index, src.splitlines())]


# --- host provenance ----------------------------------------------------

def _is_str(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _numpy_attrs(cls_node: ast.ClassDef) -> Set[str]:
    """`self.X` attributes the class assigns only numpy constructor
    results (`np.zeros`, `np.full`, ...): the host mirrors."""
    seen: Dict[str, bool] = {}
    for node in ast.walk(cls_node):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    v = node.value
                    ok = isinstance(node, ast.Assign) \
                        and isinstance(v, ast.Call) \
                        and isinstance(v.func, ast.Attribute) \
                        and isinstance(v.func.value, ast.Name) \
                        and v.func.value.id in ("np", "numpy")
                    seen[t.attr] = seen.get(t.attr, True) and ok
    return {a for a, ok in seen.items() if ok}


def _host_annotation(ann) -> bool:
    if ann is None:
        return False
    names = [n for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))]
    leaves = [n.attr if isinstance(n, ast.Attribute) else n.id
              for n in names
              if not (isinstance(n, ast.Name) and any(
                  isinstance(a, ast.Attribute) and a.value is n
                  for a in names))]
    return bool(leaves) and all(
        l in _HOST_TYPES or l in ("np", "numpy") for l in leaves)


def _class_host_attrs(fn: _Fn) -> Set[str]:
    s = fn.parent
    while s is not None and not getattr(s, "is_class", False):
        s = s.parent
    return getattr(s, "host_attrs", set()) if s is not None else set()


def _host_names(fn: _Fn, aliases) -> Set[str]:
    """Names the function binds only from host expressions, to a
    fixpoint (a name bound from anything else anywhere is out): host
    parameters by annotation, assignments, and loop targets over a host
    iterable."""
    host: Set[str] = set()
    node = fn.node
    if not isinstance(node, ast.Lambda):
        args = node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _host_annotation(a.annotation):
                host.add(a.arg)
    binds: Dict[str, List[ast.AST]] = {}

    def bind(target, value):
        if isinstance(target, ast.Name):
            binds.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:  # an element of host data is host
                bind(e, value)

    for sub in _own_stmt_nodes(fn.node):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                bind(t, sub.value)
        elif isinstance(sub, ast.AnnAssign) \
                and isinstance(sub.target, ast.Name) \
                and _host_annotation(sub.annotation):
            host.add(sub.target.id)  # `n: int = ...` declares a host value
        elif isinstance(sub, (ast.For, ast.AsyncFor, ast.comprehension)):
            bind(sub.target, sub.iter)
    changed = True
    while changed:
        changed = False
        for name, values in binds.items():
            if name in host or name in fn.params:
                continue
            if all(_is_host_expr(v, aliases, host, fn) for v in values):
                host.add(name)
                changed = True
    return host


def _is_host_expr(node, aliases, host: Set[str], fn=None) -> bool:
    """True when `node` is host data: a literal, shape-level data, a
    string-keyed lookup, a numpy expression, a host mirror of the
    class, or a host name."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_host_expr(e, aliases, host, fn) for e in node.elts)
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return True
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and fn is not None and node.attr in _class_host_attrs(fn):
            return True
        dotted, known = _dotted(node, aliases)
        return bool(known and dotted and dotted.startswith("numpy."))
    if isinstance(node, ast.Subscript):
        return _is_host_expr(node.value, aliases, host, fn)
    if isinstance(node, ast.Call):
        dotted, known = _dotted(node.func, aliases)
        if dotted in _SAFE_TEST_CALLS or dotted == "range" or (
                known and dotted and dotted.startswith("numpy.")):
            return True
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _STATIC_METHODS:
                return True
            if f.attr == "get" and len(node.args) == 2 \
                    and _is_str(node.args[0]) \
                    and isinstance(node.args[1], ast.Constant):
                # `attrs.get("k", 0)`: a literal default names a host value
                return True
            return _is_host_expr(f.value, aliases, host, fn)
        if isinstance(f, ast.Name) and (f.id in _HOST_CAST_BUILTINS
                                        or f.id in _HOST_BUILTINS):
            return all(_is_host_expr(a, aliases, host, fn)
                       for a in node.args)
        return False
    if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare)):
        parts = ([node.left, node.right] if isinstance(node, ast.BinOp)
                 else node.values if isinstance(node, ast.BoolOp)
                 else [node.left] + node.comparators)
        return all(_is_host_expr(p, aliases, host, fn) for p in parts)
    if isinstance(node, ast.UnaryOp):
        return _is_host_expr(node.operand, aliases, host, fn)
    if isinstance(node, ast.IfExp):
        return (_is_host_expr(node.body, aliases, host, fn)
                and _is_host_expr(node.orelse, aliases, host, fn))
    return False


# --- per-function checks ----------------------------------------------

def _parent_map(root):
    parents = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _safe_usage(name_node, parents, aliases) -> bool:
    cur = name_node
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, ast.Attribute) and parent.value is cur:
            if parent.attr in _STATIC_ATTRS:
                return True
            if parent.attr in _STATIC_METHODS and isinstance(
                    parents.get(parent), ast.Call):
                return True
            if parent.attr == "get":
                # `if ins.get("H0"):` tests whether an optional slot of
                # an op's input mapping is wired (a list, or None)
                call = parents.get(parent)
                if isinstance(call, ast.Call) and call.args \
                        and _is_str(call.args[0]):
                    return True
        if isinstance(parent, ast.Call):
            dotted, _ = _dotted(parent.func, aliases)
            if dotted in _SAFE_TEST_CALLS:
                return True
        if isinstance(parent, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in parent.ops):
                return True
        cur = parent
    return False


def _test_param_hazard(test, fn: _Fn, aliases, host: Set[str]
                       ) -> Optional[str]:
    """Name of a root's parameter branched on unsafely, or None (a
    parameter annotated with a host type is host data)."""
    parents = _parent_map(test)
    for node in ast.walk(test):
        if not (isinstance(node, ast.Name) and node.id in fn.params):
            continue
        if node.id == "self" or node.id in host \
                or _safe_usage(node, parents, aliases):
            continue
        return node.id
    return None


def _has_generator(call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _check_fn(fn: _Fn, index: _ModuleIndex, path: str,
              diags: List[Diagnostic]):
    aliases = index.aliases
    host = _host_names(fn, aliases)
    for node in _own_stmt_nodes(fn.node):
        if isinstance(node, ast.Call):
            func = node.func
            dotted, known = _dotted(func, aliases)
            if isinstance(func, ast.Name):
                name = func.id
                if (name in _HOST_CAST_BUILTINS and name not in aliases
                        and node.args
                        and not all(_is_host_expr(a, aliases, host, fn)
                                    for a in node.args)):
                    diags.append(make(
                        "T001", path, node.lineno, fn.qualname, name,
                        "%s() of a value that may lie on the card reads "
                        "it back: the host waits for the device" % name))
            if isinstance(func, ast.Attribute) and not (
                    known and dotted and "." in dotted):
                attr = func.attr
                if attr in _HOST_SYNC_METHODS and not _is_host_expr(
                        func.value, aliases, host, fn):
                    diags.append(make(
                        "T001", path, node.lineno, fn.qualname,
                        ".%s" % attr,
                        ".%s() in a sync-free function waits for the "
                        "device" % attr))
                elif attr == "to" and any(
                        _is_str(a) and a.value == "cpu"
                        for a in list(node.args)
                        + [k.value for k in node.keywords]):
                    diags.append(make(
                        "T001", path, node.lineno, fn.qualname, ".to",
                        ".to('cpu') in a sync-free function copies to "
                        "the host and waits for the device"))
                elif attr in _TORCH_DRAW_METHODS \
                        and not _has_generator(node):
                    diags.append(make(
                        "T002", path, node.lineno, fn.qualname,
                        ".%s" % attr,
                        ".%s() draws from torch's global RNG: pass a "
                        "seeded generator= (threefry parity)" % attr))
            if dotted and known:
                if dotted in _HOST_SYNC_CALLS and not (
                        dotted.startswith("numpy.") and node.args
                        and all(_is_host_expr(a, aliases, host, fn)
                                for a in node.args)):
                    diags.append(make(
                        "T001", path, node.lineno, fn.qualname, dotted,
                        "%s in a sync-free function waits for the device"
                        % dotted))
                elif dotted.startswith(_HOST_DRAW_PREFIXES):
                    diags.append(make(
                        "T002", path, node.lineno, fn.qualname, dotted,
                        "%s draws on the host from a global RNG: the "
                        "port's draws are seeded threefry counters"
                        % dotted))
                elif dotted in _TORCH_DRAWS and not _has_generator(node):
                    diags.append(make(
                        "T002", path, node.lineno, fn.qualname, dotted,
                        "%s without generator= draws from torch's global "
                        "RNG: pass a seeded generator (threefry parity)"
                        % dotted))
        elif isinstance(node, (ast.If, ast.While)):
            hazard = _test_param_hazard(node.test, fn, aliases, host)
            if hazard is not None:
                diags.append(make(
                    "T003", path, node.lineno, fn.qualname, hazard,
                    "branching on parameter %r of a sync-free function: "
                    "on a tensor the branch is an implicit bool(), a "
                    "read back to the host" % hazard))


# --- T005 -------------------------------------------------------------

# the same annotation lock_lint's thread-domain check learns from:
# `def _loop(self):  # thread: replica`
_THREAD_ANNOT_RE = re.compile(r"#\s*thread\s*:\s*(\w[\w\-]*)")


def _sched_roots(cls_node: ast.ClassDef, src_lines) -> Dict[str, str]:
    """method name -> thread domain, from `# thread:` annotations on
    the def line(s) — the declared host-side scheduler loops."""
    roots: Dict[str, str] = {}
    for item in cls_node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        m = _annotated(item, src_lines, _THREAD_ANNOT_RE)
        if m:
            roots[item.name] = m.group(1)
    return roots


def _self_calls(methods) -> Dict[str, Set[str]]:
    calls: Dict[str, Set[str]] = {}
    for name, node in methods.items():
        out: Set[str] = set()
        for sub in _own_stmt_nodes(node):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == "self"
                    and sub.func.attr in methods):
                out.add(sub.func.attr)
        calls[name] = out
    return calls


def _check_sched_dispatch(tree, src: str, index: _ModuleIndex, path: str,
                          diags: List[Diagnostic]):
    """T005: `torch.*` device calls reachable from a `# thread:`
    annotated method through the same-class call graph."""
    src_lines = src.splitlines()
    for cls_node in tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        roots = _sched_roots(cls_node, src_lines)
        if not roots:
            continue
        methods = {
            item.name: item for item in cls_node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        calls = _self_calls(methods)
        via: Dict[str, Tuple[str, str]] = {}  # name -> (root, domain)
        frontier = [(name, name, dom) for name, dom in roots.items()]
        while frontier:
            name, root, dom = frontier.pop()
            if name in via:
                continue
            via[name] = (root, dom)
            for callee in sorted(calls.get(name, ())):
                if callee not in via:
                    frontier.append((callee, root, dom))
        for name in sorted(via):
            root, dom = via[name]
            qual = "%s.%s" % (cls_node.name, name)
            for sub in _own_stmt_nodes(methods[name]):
                if not isinstance(sub, ast.Call):
                    continue
                dotted, known = _dotted(sub.func, index.aliases)
                if not (known and dotted and (dotted == "torch"
                                              or dotted.startswith(
                                                  "torch."))):
                    continue
                if dotted in _HOST_TORCH:
                    continue
                reach = ("a '# thread: %s' scheduler loop" % dom
                         if name == root else
                         "'%s.%s' (# thread: %s)"
                         % (cls_node.name, root, dom))
                diags.append(make(
                    "T005", path, sub.lineno, qual, dotted,
                    "%s dispatches device work from %s: a control "
                    "thread that launches work per step serializes the "
                    "fleet behind one queue — move it into the engine's "
                    "step or precompute on the host" % (dotted, reach)))


# --- entry points ------------------------------------------------------

def lint_file(path: str) -> List[Diagnostic]:
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    index = _ModuleIndex(tree)
    rel = rel_path(path)
    diags: List[Diagnostic] = []
    linted = _linted_set(index, _root_fns(index, src.splitlines()))
    for fn in sorted(linted, key=lambda f: f.node.lineno):
        _check_fn(fn, index, rel, diags)
    _check_sched_dispatch(tree, src, index, rel, diags)
    diags.sort(key=lambda d: (d.path, d.line, d.code))
    return diags


def lint_paths(paths=None) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for f in walk_python_files(paths, HOT_PATHS):
        diags.extend(lint_file(f))
    return diags
