"""Mesh sharding-spec lint: static checks on the port's mesh surface
(the port's counterpart of paddle_tpu/analysis/shard_lint.py).

The port's mesh code names axes in literals — `P(None, "model")`
specs, `MeshAxis.of(mesh, "seq")`, `mesh.group("data")`, `axis="expert"`
defaults — and a typo'd name fails only on a real multi-rank mesh, as a
KeyError deep inside a step (or, where a helper drops axes the mesh
lacks, as silent replication). Run the check at lint time instead:

  S001 unbound-axis-name    a string axis name that no mesh convention
                            or in-file binding declares, in a literal
                            `P(...)` / `PartitionSpec(...)` /
                            `NamedSharding(mesh, spec)`, in
                            `MeshAxis.of(mesh, name)`, in a mesh's
                            `group` / `index` / `extent` call, or in an
                            `axis=` / `axis_name=` / `*_axis=` keyword
                            (the axis arguments of the mesh bodies and of
                            parallel/collectives.py's MeshAxis)
  S002                      no counterpart (`diagnostics.NO_COUNTERPART`):
                            the port has no shard_map
  S003 host-sync-on-sharded host materialization (`np.asarray`,
                            `float()`/`int()`, `.item()`, `.tolist()`,
                            `.cpu()`, `.numpy()`) of device band state
                            (`self._dev[...]` / `self._band(...)`) from a
                            `# thread:` scheduler method or anything it
                            reaches in-class — on a mesh it blocks every
                            rank behind one host round-trip
  S004 spec-rank-mismatch   a spec with more entries than the literal
                            rank of the tensor it places
                            (`shard_parameter(x, P(...))` on a
                            literal-shaped `torch.zeros` / `.reshape` /
                            `create_parameter(shape=[...])`): the
                            executor raises only when the mesh runs

Axis-name vocabulary for S001 = the repo's mesh conventions
(parallel/mesh.py: 'data', 'model', 'seq', 'expert', 'pipe', plus the
'dcn'/'dcn_*' slice-crossing tier) UNION every name the linted file
itself binds: string defaults of `axis`/`axis_name`/`*_axis`
parameters, `Mesh(ranks, names, ...)` literals, and
make_mesh/make_hybrid_mesh axes-dict keys. Non-literal axis arguments
are out of scope by design — the lint hunts literal typos, not
dataflow.

Pure AST; reuses trace_lint's module index (aliases, scopes, call
sites) so the two passes cannot disagree on resolution.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, make, rel_path, walk_python_files
from .trace_lint import (_Fn, _ModuleIndex, _dotted, _own_stmt_nodes,
                         _sched_roots, _self_calls)

__all__ = ["lint_file", "lint_paths", "DEFAULT_PATHS", "CANONICAL_AXES"]

# the mesh-facing surface; `--all` lints exactly these: the parallel
# stack, the serving engine, and the LM module whose `param_specs` holds
# the port's tensor-parallel specs
DEFAULT_PATHS = [
    "paddle_tpu_torch/parallel",
    "paddle_tpu_torch/serving/engine.py",
    "paddle_tpu_torch/models/transformer.py",
]

# parallel/mesh.py's axis conventions + the pipeline axis; 'dcn'-prefixed
# names are the make_hybrid_mesh slice-crossing tier
CANONICAL_AXES = frozenset(("data", "model", "seq", "expert", "pipe"))

# a mesh's methods that take axis names
_MESH_AXIS_METHODS = {"group", "index", "extent"}

_ARRAY_CTORS = {"torch.zeros", "torch.ones", "torch.full", "torch.empty",
                "torch.randn", "torch.rand", "numpy.zeros", "numpy.ones",
                "numpy.full", "numpy.empty"}
_MATERIALIZERS = {"numpy.asarray", "numpy.array"}
_HOST_CASTS = {"float", "int", "bool"}
_READBACK_METHODS = {"item", "tolist", "cpu", "numpy"}


def _last(dotted: Optional[str]) -> Optional[str]:
    return dotted.split(".")[-1] if dotted else None


def _is_partition_spec(dotted: Optional[str]) -> bool:
    """PartitionSpec, or mesh.py's `P` alias of it imported by name."""
    return _last(dotted) == "PartitionSpec" or (
        dotted is not None and dotted.endswith("mesh.P"))


def _extend_assign_aliases(tree, index: _ModuleIndex):
    """Fold module-level `P = PartitionSpec` style rebinds into the
    alias table (mesh.py's idiom — ImportFrom alone misses it)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Name):
            src = node.value.id
            if src in index.aliases:
                index.aliases[node.targets[0].id] = index.aliases[src]
            elif src == "PartitionSpec":  # rebinding a local class
                index.aliases[node.targets[0].id] = "PartitionSpec"


def _axis_strings(node) -> List[Tuple[str, int]]:
    """(axis-name, lineno) for a string constant or a tuple/list of
    them — the shapes an axis operand takes."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [(node.value, node.lineno)]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            out += _axis_strings(e)
        return out
    return []


def _is_axis_kw(name: Optional[str]) -> bool:
    return name is not None and (name in ("axis", "axis_name")
                                 or name.endswith("_axis"))


def _axis_vocab(tree, index: _ModuleIndex) -> Set[str]:
    """Every axis name the file binds, plus the repo conventions."""
    vocab = set(CANONICAL_AXES)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            args = node.args
            named = list(zip(reversed(args.posonlyargs + args.args),
                             reversed(args.defaults)))
            named += [(a, d) for a, d in zip(args.kwonlyargs,
                                             args.kw_defaults)
                      if d is not None]
            for a, d in named:
                if _is_axis_kw(a.arg):
                    for name, _ in _axis_strings(d):
                        vocab.add(name)
        elif isinstance(node, ast.Call):
            last = _last(_dotted(node.func, index.aliases)[0])
            if last == "Mesh" and len(node.args) >= 2:
                for name, _ in _axis_strings(node.args[1]):
                    vocab.add(name)
            if last in ("make_mesh", "make_hybrid_mesh"):
                for sub in list(node.args) + [k.value
                                              for k in node.keywords]:
                    if isinstance(sub, ast.Dict):
                        for k in sub.keys:
                            if isinstance(k, ast.Constant) \
                                    and isinstance(k.value, str):
                                vocab.add(k.value)
    return vocab


def _scope_qual(scope: Optional[_Fn]) -> str:
    return scope.qualname if scope is not None else "<module>"


def _is_meshy(node) -> bool:
    """The receiver of a `group`/`index`/`extent` call is a mesh:
    `mesh`, `self.mesh`, `ctx.mesh`, `self._mesh` ..."""
    name = node.attr if isinstance(node, ast.Attribute) else \
        node.id if isinstance(node, ast.Name) else ""
    return name.lstrip("_").endswith("mesh")


# --- S001 --------------------------------------------------------------

def _check_axis_names(index: _ModuleIndex, vocab: Set[str], rel: str,
                      diags: List[Diagnostic]):
    for call, scope in index.calls:
        dotted, _ = _dotted(call.func, index.aliases)
        last = _last(dotted)
        sites: List[Tuple[str, int]] = []
        if _is_partition_spec(dotted):
            for a in call.args:
                sites += _axis_strings(a)
        elif last == "NamedSharding" and len(call.args) >= 2 \
                and isinstance(call.args[1], (ast.Tuple, ast.List)):
            sites += _axis_strings(call.args[1])
        elif dotted is not None and dotted.endswith("MeshAxis.of") \
                and len(call.args) >= 2:
            sites += _axis_strings(call.args[1])
        elif isinstance(call.func, ast.Attribute) \
                and call.func.attr in _MESH_AXIS_METHODS \
                and _is_meshy(call.func.value) and call.args:
            sites += _axis_strings(call.args[0])
        for kw in call.keywords:
            if _is_axis_kw(kw.arg):
                sites += _axis_strings(kw.value)
        for name, lineno in sites:
            if name in vocab or name.startswith("dcn"):
                continue
            diags.append(make(
                "S001", rel, lineno, _scope_qual(scope), name,
                "axis name %r is bound by no mesh convention or in-file "
                "binding (have: %s) — an unbound axis raises only on a "
                "real mesh, or silently replicates"
                % (name, ", ".join(sorted(vocab)))))


# --- S003 --------------------------------------------------------------

def _names_in_targets(targets) -> List[str]:
    out: List[str] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Name):
            out.append(t.id)
    return out


def _mentions_device_band(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "_dev":
            return True
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "_band":
            return True
    return False


def _check_sched_materialize(tree, src: str, index: _ModuleIndex,
                             rel: str, diags: List[Diagnostic]):
    """S003: a `# thread:` scheduler method (or anything it reaches
    in-class) materializing device band state on the host."""
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
        reach: Set[str] = set()
        frontier = list(roots)
        while frontier:
            name = frontier.pop()
            if name in reach:
                continue
            reach.add(name)
            frontier.extend(calls.get(name, ()))
        for name in sorted(reach):
            node = methods[name]
            qual = "%s.%s" % (cls_node.name, name)
            tainted: Set[str] = set()
            for sub in _own_stmt_nodes(node):
                if isinstance(sub, ast.Assign) \
                        and _mentions_device_band(sub.value):
                    tainted.update(_names_in_targets(sub.targets))
            for sub in _own_stmt_nodes(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                dotted, known = _dotted(f, index.aliases)
                is_mat = (dotted in _MATERIALIZERS and known) \
                    or (isinstance(f, ast.Name) and f.id in _HOST_CASTS
                        and f.id not in index.aliases)
                is_read = isinstance(f, ast.Attribute) \
                    and f.attr in _READBACK_METHODS
                if not (is_mat or is_read):
                    continue
                probe = sub.args[0] if (is_mat and sub.args) else \
                    (f.value if is_read else None)
                if probe is None:
                    continue
                dirty = _mentions_device_band(probe) or any(
                    isinstance(n, ast.Name) and n.id in tainted
                    for n in ast.walk(probe))
                if dirty:
                    diags.append(make(
                        "S003", rel, sub.lineno, qual, "_dev",
                        "scheduler-thread materialization of device "
                        "band state: a '# thread:' loop that blocks on "
                        "the device stalls every rank of a mesh behind "
                        "one host round-trip"))


# --- S004 --------------------------------------------------------------

def _shape_rank(shape) -> Optional[int]:
    if isinstance(shape, (ast.Tuple, ast.List)):
        if any(isinstance(e, ast.Starred) for e in shape.elts):
            return None
        return len(shape.elts)
    if isinstance(shape, ast.Constant) and isinstance(shape.value, int):
        return 1
    return None


def _literal_rank(node, ranks: Dict[str, int],
                  index: _ModuleIndex) -> Optional[int]:
    """Statically-known rank of an expression: a tracked Name, a
    literal-shape torch/numpy constructor, `.reshape(...)` /
    `.view(...)`, or `create_parameter(shape=[...])`."""
    if isinstance(node, ast.Name):
        return ranks.get(node.id)
    if not isinstance(node, ast.Call):
        return None
    dotted, known = _dotted(node.func, index.aliases)
    if dotted in _ARRAY_CTORS and known and node.args:
        if len(node.args) > 1 and dotted.startswith("torch.") and all(
                isinstance(a, ast.Constant) and isinstance(a.value, int)
                for a in node.args):
            return len(node.args)  # torch.zeros(4, 8)
        return _shape_rank(node.args[0])
    if _last(dotted) == "create_parameter":
        for kw in node.keywords:
            if kw.arg == "shape":
                return _shape_rank(kw.value)
        return _shape_rank(node.args[0]) if node.args else None
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("reshape", "view"):
        args = node.args
        if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
            return _shape_rank(args[0])
        if args and not any(isinstance(a, ast.Starred) for a in args):
            return len(args)
    return None


def _spec_entry_count(node, index: _ModuleIndex) -> Optional[int]:
    """Number of dimension entries in a P(...)/PartitionSpec(...) call
    or a NamedSharding(mesh, spec) wrapper; None when not literal."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return _shape_rank(node)
    if not isinstance(node, ast.Call):
        return None
    dotted, _ = _dotted(node.func, index.aliases)
    if _last(dotted) == "NamedSharding" and len(node.args) >= 2:
        return _spec_entry_count(node.args[1], index)
    if _is_partition_spec(dotted):
        if any(isinstance(a, ast.Starred) for a in node.args):
            return None
        return len(node.args)
    return None


def _check_spec_rank(index: _ModuleIndex, rel: str,
                     diags: List[Diagnostic]):
    for fn in index.all_fns:
        if getattr(fn, "is_class", False):
            continue
        ranks: Dict[str, int] = {}
        for sub in _own_stmt_nodes(fn.node):
            if isinstance(sub, ast.Assign):
                r = _literal_rank(sub.value, ranks, index)
                if r is not None:
                    for name in _names_in_targets(sub.targets):
                        ranks[name] = r
        for sub in _own_stmt_nodes(fn.node):
            if not isinstance(sub, ast.Call) or len(sub.args) < 2:
                continue
            dotted, _ = _dotted(sub.func, index.aliases)
            if _last(dotted) != "shard_parameter":
                continue
            rank = _literal_rank(sub.args[0], ranks, index)
            n_spec = _spec_entry_count(sub.args[1], index)
            if rank is None or n_spec is None or n_spec <= rank:
                continue
            diags.append(make(
                "S004", rel, sub.lineno, fn.qualname,
                "rank%d-spec%d" % (rank, n_spec),
                "PartitionSpec names %d dimensions but the tensor has "
                "statically-known rank %d — the executor raises only "
                "when the mesh runs" % (n_spec, rank)))


# --- entry points ------------------------------------------------------

def lint_file(path: str) -> List[Diagnostic]:
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    index = _ModuleIndex(tree)
    _extend_assign_aliases(tree, index)
    rel = rel_path(path)
    vocab = _axis_vocab(tree, index)
    diags: List[Diagnostic] = []
    _check_axis_names(index, vocab, rel, diags)
    _check_sched_materialize(tree, src, index, rel, diags)
    _check_spec_rank(index, rel, diags)
    diags.sort(key=lambda d: (d.path, d.line, d.code, d.detail))
    return diags


def lint_paths(paths=None) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for f in walk_python_files(paths, DEFAULT_PATHS):
        diags.extend(lint_file(f))
    return diags
