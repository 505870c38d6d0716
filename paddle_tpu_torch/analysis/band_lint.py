"""Band-lifecycle verifier: static propagation guarantees for the
engine's side-bands (the port's copy of paddle_tpu/analysis/band_lint.py,
keyed to the port's serving files).

The serving engine's state is a set of named BANDS: per-slot host
mirrors (`_BANDS` in serving/engine.py — tok/pos/alive/…) with device
copies managed by a dirty-set protocol (`_mark_dirty` / `_band`), and
per-block CACHE bands in the KV pytree (k/v payloads plus the ISSUE 14
k_scale/v_scale side-bands). Every band must survive every lifecycle
verb — alias, COW, serialize, import, resume, retire, sync — and the
change history shows this exact defect class (a side-band missed at
COW/serialize, a dirty-flag set drifting from `_BANDS`) escaping to
manual review more than once. This pass makes the registry declarative
and the propagation checkable:

  B001 band-not-propagated  a function annotated `# band-verb: <verb>`
                            does not reference every band the registry
                            requires for that verb (a COW that copies
                            payload but not k_scale), or a lifecycle
                            file is missing a required verb annotation
                            entirely (the check silently dying is
                            itself a finding)
  B002 dirty-flag-gap       a method of a `_mark_dirty`-bearing class
                            mutates a host band mirror (`self._tok[s] =
                            …`) without marking it dirty, adopting the
                            device copy, or every caller doing so; and
                            `_mark_dirty("name")` names outside the
                            band registry (a typo silently dirties
                            nothing)
  B003 wire-schema-asymmetry the kv_store record schema written by the
                            serialize side (`make_block_record` /
                            `_encode`) drifted from what the import
                            side (`_decode`) reads back — a field
                            serialized but never imported is lost at
                            every handoff
  B004 device-adoption-drift a band adopted as device truth
                            (`self._dev[x] = …` / `_dirty.
                            difference_update((…))`) that is not in
                            `_DEVICE_ADVANCED`, a chain gate comparing
                            `_dirty` against a literal set != the
                            registry, or `_DEVICE_ADVANCED` naming a
                            band outside `_BANDS` — each one desyncs
                            `_can_chain` from what the compiled window
                            actually advances

The registry is DERIVED, not duplicated: `_BANDS`/`_DEVICE_ADVANCED`
are parsed from the port's serving/engine.py module literals and the
cache band set from the paged-cache dict literal in the port's
models/transformer.py (`init_paged_kv_cache`), so the lint cannot drift
from the engine (a file under lint may also declare its own
`_BANDS`/`_DEVICE_ADVANCED`/`_CACHE_BANDS` literals — the test corpora
do). A function covers a cache-band requirement either by naming every
band or by iterating the band dict GENERICALLY — generic iteration is
the idiom that stays correct when a future pool adds bands, which is
exactly why the mutation drill (tests) replaces it with explicit keys
and expects B001. Generic means one of:

  * a dict comprehension keyed by its own loop variable
    (`{band: f(buf) for band, buf in kv.items()}`);
  * a loop over a layer's band dict's `.values()` / `.items()`
    (`for kv in self._cache: for buf in kv.values(): ...`, the port's
    in-place COW);
  * a subscript by a band name bound by a loop, or derived from one
    (`for name, dtype, shape in rec["meta"]: ... band = ...name...;
    self._cache[li][band]`, the port's record upload, which takes each
    band's name from the record it restores).

Annotation grammar (on the `def` line or the lines down to the first
body statement, the `# thread:` placement rule):

    def _make_cow(self):  # band-verb: cow
    def _admit(self, h, s):  # band-verb: alias, import

Pure AST — no torch import, the package's import-light rule.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import (Diagnostic, make, rel_path, repo_root,
                          walk_python_files)

__all__ = ["lint_file", "lint_paths", "load_registry", "BandRegistry",
           "DEFAULT_PATHS", "VERBS"]

# the band-lifecycle files; `--all` lints exactly these
DEFAULT_PATHS = [
    "paddle_tpu_torch/serving/engine.py",
    "paddle_tpu_torch/serving/kv_blocks.py",
    "paddle_tpu_torch/serving/kv_store.py",
    "paddle_tpu_torch/serving/prefix_cache.py",
    "paddle_tpu_torch/serving/fleet.py",
]

VERBS = ("alias", "cow", "serialize", "import", "resume", "retire",
         "sync")

_ANNOT_RE = re.compile(r"#\s*band-verb\s*:\s*([\w\-, ]+)")

# requirement sentinels, resolved against the parsed registry
_CACHE = "<cache-bands>"
_DEVICE = "<device-advanced>"

# verb -> band names a function carrying that verb must propagate.
# The engine's own names are the default; host-bookkeeping files that
# track different state override per (repo-relative path, verb) below.
DEFAULT_VERB_BANDS: Dict[str, Tuple[str, ...]] = {
    "alias": ("tables", "limits", "aidx"),
    "cow": (_CACHE,),
    "serialize": (_CACHE,),
    "import": (_CACHE,),
    "resume": ("tok", "pos", "alive", "temps", "counts", "base_keys",
               "eos"),
    "retire": ("alive", "aidx", "tables", "limits"),
    "sync": (_DEVICE,),
}

FILE_VERB_BANDS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    # kv_store's bands are the wire-record fields (B003 audits the
    # full schema; B001 pins the geometry-critical trio)
    ("paddle_tpu_torch/serving/kv_store.py", "serialize"):
        ("tokens", "meta", "payload"),
    ("paddle_tpu_torch/serving/kv_store.py", "import"):
        ("tokens", "meta", "payload"),
    ("paddle_tpu_torch/serving/kv_store.py", "alias"): ("tokens",),
    ("paddle_tpu_torch/serving/kv_store.py", "retire"):
        ("parent", "nbytes"),
    # allocator / trie: ref-counts ARE the band being propagated
    ("paddle_tpu_torch/serving/kv_blocks.py", "alias"): ("refs",),
    ("paddle_tpu_torch/serving/kv_blocks.py", "retire"): ("refs", "free"),
    ("paddle_tpu_torch/serving/prefix_cache.py", "alias"): ("refs",),
    ("paddle_tpu_torch/serving/prefix_cache.py", "retire"):
        ("refs", "payload"),
    # fleet: token-level resume + durable-KV handoff side-bands
    ("paddle_tpu_torch/serving/fleet.py", "resume"):
        ("resume", "generation"),
    ("paddle_tpu_torch/serving/fleet.py", "import"):
        ("handoff_package", "handoff_meta"),
}

# verbs each lifecycle file MUST annotate somewhere: a deleted
# annotation silently disables its checks, so absence is a finding
REQUIRED_SITES: Dict[str, Tuple[str, ...]] = {
    "paddle_tpu_torch/serving/engine.py": VERBS,
    "paddle_tpu_torch/serving/kv_store.py": ("serialize", "import"),
    "paddle_tpu_torch/serving/kv_blocks.py": ("alias", "retire"),
    "paddle_tpu_torch/serving/prefix_cache.py": ("alias", "retire"),
    "paddle_tpu_torch/serving/fleet.py": ("resume", "import"),
}

_ENGINE_FILE = "paddle_tpu_torch/serving/engine.py"
_CACHE_FILE = "paddle_tpu_torch/models/transformer.py"

_FALLBACK_CACHE_BANDS = ("k", "v", "k_scale", "v_scale")


class BandRegistry(object):
    """The declarative band registry one lint run checks against."""

    def __init__(self, slot_bands: Tuple[str, ...],
                 device_advanced: Tuple[str, ...],
                 cache_bands: Tuple[str, ...]):
        self.slot_bands = tuple(slot_bands)
        self.device_advanced = frozenset(device_advanced)
        self.cache_bands = tuple(cache_bands)

    def resolve(self, names: Tuple[str, ...]) -> List[str]:
        out: List[str] = []
        for n in names:
            if n == _CACHE:
                out.extend(self.cache_bands)
            elif n == _DEVICE:
                out.extend(sorted(self.device_advanced))
            else:
                out.append(n)
        return out


def _str_tuple(node) -> Optional[Tuple[str, ...]]:
    """The string elements of a tuple/list/set literal (possibly
    wrapped in frozenset(...)/set(...)/tuple(...)), else None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("frozenset", "set", "tuple") \
            and len(node.args) == 1:
        node = node.args[0]
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return None
    out = []
    for e in node.elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.append(e.value)
    return tuple(out)


def _module_literals(tree) -> Dict[str, Tuple[str, ...]]:
    """Module-level `NAME = (tuple of str)` assignments (frozenset
    wrapping accepted) — how a linted file declares its own registry."""
    out: Dict[str, Tuple[str, ...]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            vals = _str_tuple(node.value)
            if vals is not None:
                out[node.targets[0].id] = vals
    return out


def _parse_cache_bands(tree) -> Optional[Tuple[str, ...]]:
    """Cache band names from the paged-cache layer dict literal: any
    dict literal whose string keys include both a payload band and a
    `*_scale` side-band (init_paged_cache's quantized branch)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        keys = []
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.append(k.value)
        if keys and "k" in keys and any(k.endswith("_scale")
                                        for k in keys):
            return tuple(keys)
    return None


_REGISTRY_CACHE: Dict[str, BandRegistry] = {}


def _repo_cache_bands(path: Optional[str] = None) -> Tuple[str, ...]:
    """The cache bands of the port's paged-cache builder (the fallback
    when the builder cannot be parsed)."""
    path = path or os.path.join(repo_root(), _CACHE_FILE)
    if os.path.exists(path):
        with open(path) as f:
            parsed = _parse_cache_bands(ast.parse(f.read(), filename=path))
        if parsed is not None:
            return parsed
    return _FALLBACK_CACHE_BANDS


def load_registry(engine_path: Optional[str] = None,
                  cache_path: Optional[str] = None) -> BandRegistry:
    """Parse the port's registry ground truth (engine `_BANDS` /
    `_DEVICE_ADVANCED`, transformer cache dict). Cached per path pair."""
    root = repo_root()
    engine_path = engine_path or os.path.join(root, _ENGINE_FILE)
    cache_path = cache_path or os.path.join(root, _CACHE_FILE)
    ck = "%s|%s" % (engine_path, cache_path)
    if ck in _REGISTRY_CACHE:
        return _REGISTRY_CACHE[ck]
    with open(engine_path) as f:
        etree = ast.parse(f.read(), filename=engine_path)
    lits = _module_literals(etree)
    if "_BANDS" not in lits or "_DEVICE_ADVANCED" not in lits:
        raise ValueError(
            "band registry parse failed: %s defines no _BANDS/"
            "_DEVICE_ADVANCED string-tuple literals" % engine_path)
    reg = BandRegistry(lits["_BANDS"], lits["_DEVICE_ADVANCED"],
                       _repo_cache_bands(cache_path))
    _REGISTRY_CACHE[ck] = reg
    return reg


def _file_registry(tree, path: str) -> BandRegistry:
    """Registry for one linted file: its own `_BANDS` /
    `_DEVICE_ADVANCED` / `_CACHE_BANDS` literals when declared (the
    engine itself, test corpora), the repo registry otherwise. A file
    that declares `_BANDS` but no `_CACHE_BANDS` (the engine) takes the
    cache bands parsed from the paged-cache builder."""
    lits = _module_literals(tree)
    if "_BANDS" in lits:
        return BandRegistry(
            lits["_BANDS"],
            lits.get("_DEVICE_ADVANCED", ()),
            lits.get("_CACHE_BANDS", _repo_cache_bands()))
    repo = load_registry()
    if "_CACHE_BANDS" in lits:
        return BandRegistry(repo.slot_bands, tuple(repo.device_advanced),
                            lits["_CACHE_BANDS"])
    return repo


# --- function harvest --------------------------------------------------

class _FnInfo(object):
    """Everything B001/B002 need about one def: referenced band-ish
    names, generic-iteration evidence, local dirty coverage, calls."""

    def __init__(self, node, qualname, cls_name):
        self.node = node
        self.qualname = qualname
        self.cls_name = cls_name  # enclosing class, or None
        self.verbs: List[str] = []
        self.refs: Set[str] = set()
        self.generic = False
        self.self_calls: Set[str] = set()   # self.m() targets
        self.local_calls: Set[str] = set()  # bare-name call targets
        self.dirty_cov: Set[str] = set()    # bands covered locally
        self.dirty_all = False              # bare _mark_dirty()
        self.mutations: List[Tuple[str, int]] = []  # (band, lineno)
        self.schema: Optional[Set[str]] = None
        self.schema_partial = False


def _annotated_verbs(item, src_lines) -> List[str]:
    body_start = item.body[0].lineno if item.body else item.lineno
    for ln in range(item.lineno, body_start + 1):
        if ln - 1 < len(src_lines):
            m = _ANNOT_RE.search(src_lines[ln - 1])
            if m:
                return [v.strip() for v in m.group(1).split(",")
                        if v.strip()]
    return []


def _walk_fn(fn_node):
    """Walk a def's FULL body including nested defs/lambdas (a COW
    maker's compiled body is a nested def) but not the def node
    itself."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _loop_targets(fn_node) -> Set[str]:
    """Names bound as for-loop or comprehension targets anywhere in
    the function — the generic-iteration variables — and the names
    assigned from an expression over one (`band` in `li, _, band =
    str(name).partition(".")` with `name` loop-bound), to a fixpoint."""
    out: Set[str] = set()

    def names_of(t):
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)

    assigns = []
    for node in _walk_fn(fn_node):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            names_of(node.target)
        elif isinstance(node, ast.comprehension):
            names_of(node.target)
        elif isinstance(node, ast.Assign):
            assigns.append(node)
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if not any(isinstance(n, ast.Name) and n.id in out
                       for n in ast.walk(node.value)):
                continue
            for t in node.targets:
                for n in ast.walk(t):
                    # bound names only: not `dst` in `raw[dst] = ...`
                    if isinstance(n, ast.Name) \
                            and isinstance(n.ctx, ast.Store) \
                            and n.id not in out:
                        out.add(n.id)
                        changed = True
    return out


def _iterates_band_dict(node, loop_names: Set[str]) -> bool:
    """A for-loop or comprehension over `<d>.values()` / `<d>.items()`
    where `<d>` is a loop-bound name (a layer's band dict taken from
    the cache) or a subscript (`self._cache[li]`)."""
    it = node.iter
    if not (isinstance(it, ast.Call) and not it.args
            and isinstance(it.func, ast.Attribute)
            and it.func.attr in ("values", "items")):
        return False
    base = it.func.value
    return isinstance(base, ast.Subscript) or (
        isinstance(base, ast.Name) and base.id in loop_names)


def _dev_store_keys(stmt_targets) -> Set[str]:
    """String keys of `self._dev["x"]` subscript assignment targets
    (tuple targets included)."""
    out: Set[str] = set()
    stack = list(stmt_targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Subscript) \
                and isinstance(t.value, ast.Attribute) \
                and t.value.attr == "_dev" \
                and isinstance(t.slice, ast.Constant) \
                and isinstance(t.slice.value, str):
            out.add(t.slice.value)
    return out


def _band_of_target(t, slot_bands) -> Optional[str]:
    """The slot band a store target mutates: `self._tok` or
    `self._tok[...]` (any attribute base named `_<band>`)."""
    if isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute) and t.attr.startswith("_") \
            and t.attr[1:] in slot_bands:
        return t.attr[1:]
    return None


def _harvest_schema(info: _FnInfo):
    """Record schema of a serialize/import function: keys of a
    returned dict literal (full), or the keys subscript-assigned onto
    a returned `dict(...)` copy (partial — `_encode`'s shape)."""
    node = info.node
    dict_keys: Dict[str, Tuple[Set[str], bool]] = {}  # var -> (keys, partial)
    assigns = [sub for sub in _walk_fn(node)
               if isinstance(sub, ast.Assign) and len(sub.targets) == 1]
    # two passes: the tree walk is not source-ordered, so register the
    # dict copies before attributing subscript stores to them
    for sub in assigns:
        t = sub.targets[0]
        if isinstance(t, ast.Name):
            if isinstance(sub.value, ast.Dict):
                keys = {k.value for k in sub.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
                dict_keys[t.id] = (keys, False)
            elif isinstance(sub.value, ast.Call) \
                    and isinstance(sub.value.func, ast.Name) \
                    and sub.value.func.id == "dict" \
                    and sub.value.args:
                dict_keys[t.id] = (set(), True)
    for sub in assigns:
        t = sub.targets[0]
        if isinstance(t, ast.Subscript) \
                and isinstance(t.value, ast.Name) \
                and t.value.id in dict_keys \
                and isinstance(t.slice, ast.Constant) \
                and isinstance(t.slice.value, str):
            dict_keys[t.value.id][0].add(t.slice.value)
    for sub in _walk_fn(node):
        if not isinstance(sub, ast.Return) or sub.value is None:
            continue
        if isinstance(sub.value, ast.Dict):
            keys = {k.value for k in sub.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
            if keys:
                info.schema = keys
                info.schema_partial = False
                return
        elif isinstance(sub.value, ast.Name) \
                and sub.value.id in dict_keys:
            keys, partial = dict_keys[sub.value.id]
            info.schema = keys
            info.schema_partial = partial
            return


def _harvest(tree, src: str, registry: BandRegistry
             ) -> Tuple[List[_FnInfo], Dict[str, Dict[str, _FnInfo]]]:
    """All defs with their band facts, plus per-class method tables."""
    src_lines = src.splitlines()
    infos: List[_FnInfo] = []
    classes: Dict[str, Dict[str, _FnInfo]] = {}

    def visit_fn(item, qual, cls_name):
        info = _FnInfo(item, qual, cls_name)
        info.verbs = _annotated_verbs(item, src_lines)
        loop_names = _loop_targets(item)
        for sub in _walk_fn(item):
            if isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, str):
                info.refs.add(sub.value)
            elif isinstance(sub, ast.Attribute):
                info.refs.add(sub.attr)
                if sub.attr.startswith("_"):
                    info.refs.add(sub.attr[1:])
            elif isinstance(sub, ast.Name):
                info.refs.add(sub.id)
            elif isinstance(sub, ast.Subscript) \
                    and isinstance(sub.slice, ast.Name) \
                    and sub.slice.id in loop_names:
                # kv[band] with band loop-bound: generic band iteration
                info.generic = True
            elif isinstance(sub, (ast.For, ast.AsyncFor,
                                  ast.comprehension)) \
                    and _iterates_band_dict(sub, loop_names):
                # for buf in kv.values(): generic band iteration
                info.generic = True
            elif isinstance(sub, ast.DictComp) \
                    and isinstance(sub.key, ast.Name):
                for gen in sub.generators:
                    for n in ast.walk(gen.target):
                        if isinstance(n, ast.Name) \
                                and n.id == sub.key.id:
                            info.generic = True
            elif isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute):
                    if isinstance(f.value, ast.Name) \
                            and f.value.id == "self":
                        info.self_calls.add(f.attr)
                    if f.attr == "_mark_dirty":
                        names = [a.value for a in sub.args
                                 if isinstance(a, ast.Constant)
                                 and isinstance(a.value, str)]
                        if not sub.args:
                            info.dirty_all = True
                        info.dirty_cov.update(names)
                    elif f.attr == "difference_update" \
                            and isinstance(f.value, ast.Attribute) \
                            and f.value.attr == "_dirty":
                        for a in sub.args:
                            vals = _str_tuple(a)
                            if vals is not None:
                                info.dirty_cov.update(vals)
                            elif isinstance(a, ast.Name):
                                # e.g. _DEVICE_ADVANCED by name
                                info.dirty_cov.update(
                                    registry.device_advanced)
                elif isinstance(f, ast.Name):
                    info.local_calls.add(f.id)
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                info.dirty_cov.update(_dev_store_keys(targets))
                flat = []
                stack = list(targets)
                while stack:
                    t = stack.pop()
                    if isinstance(t, (ast.Tuple, ast.List)):
                        stack.extend(t.elts)
                    else:
                        flat.append(t)
                for t in flat:
                    band = _band_of_target(t, registry.slot_bands)
                    if band is not None:
                        info.mutations.append((band, sub.lineno))
        if "serialize" in info.verbs or "import" in info.verbs:
            _harvest_schema(info)
        infos.append(info)
        return info

    def walk_body(body, prefix, cls_name, methods):
        for item in body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = "%s.%s" % (prefix, item.name) if prefix \
                    else item.name
                info = visit_fn(item, qual, cls_name)
                if methods is not None:
                    methods[item.name] = info
            elif isinstance(item, ast.ClassDef):
                cm: Dict[str, _FnInfo] = {}
                classes[item.name] = cm
                walk_body(item.body, item.name, item.name, cm)

    walk_body(tree.body, "", None, None)
    return infos, classes


# --- closures ----------------------------------------------------------

def _closure_refs(info: _FnInfo, by_name: Dict[str, _FnInfo],
                  cls_methods: Dict[str, _FnInfo]
                  ) -> Tuple[Set[str], bool]:
    """Referenced names + generic flag, transitively through same-class
    `self.m()` calls and module-level bare calls (a retire that frees
    through `_free_slot_blocks` propagates tables/limits there)."""
    seen: Set[int] = set()
    refs: Set[str] = set()
    generic = False
    stack = [info]
    while stack:
        cur = stack.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        refs |= cur.refs
        generic = generic or cur.generic
        for name in cur.self_calls:
            nxt = cls_methods.get(name)
            if nxt is not None:
                stack.append(nxt)
        for name in cur.local_calls:
            nxt = by_name.get(name)
            if nxt is not None:
                stack.append(nxt)
    return refs, generic


def _dirty_covered(band: str, info: _FnInfo,
                   cls_methods: Dict[str, _FnInfo],
                   callers: Dict[str, Set[str]],
                   _seen: Optional[Set[str]] = None) -> bool:
    """B002 coverage: the method covers the band locally, or EVERY
    same-class caller (transitively) does — `_emit` bumping counts is
    fine because every path into it marked counts dirty or adopted the
    device copy."""
    if info.dirty_all or band in info.dirty_cov:
        return True
    name = info.node.name
    seen = _seen or set()
    if name in seen:
        return True  # cycle: judged by the other members
    seen.add(name)
    ins = callers.get(name, set())
    if not ins:
        return False
    return all(_dirty_covered(band, cls_methods[c], cls_methods,
                              callers, seen)
               for c in ins if c in cls_methods)


# --- checks ------------------------------------------------------------

def _check_b001(infos, classes, registry, rel, diags):
    by_name = {i.node.name: i for i in infos if i.cls_name is None}
    seen_verbs: Set[str] = set()
    for info in infos:
        if not info.verbs:
            continue
        cls_methods = classes.get(info.cls_name, {}) \
            if info.cls_name else {}
        refs, generic = _closure_refs(info, by_name, cls_methods)
        for verb in info.verbs:
            if verb not in VERBS:
                diags.append(make(
                    "B001", rel, info.node.lineno, info.qualname,
                    "unknown-verb:%s" % verb,
                    "unknown lifecycle verb %r (have: %s)"
                    % (verb, ", ".join(VERBS))))
                continue
            seen_verbs.add(verb)
            req = FILE_VERB_BANDS.get((rel, verb))
            from_default = req is None
            if req is None:
                req = DEFAULT_VERB_BANDS[verb]
            for name in req:
                is_cache = name == _CACHE
                if from_default and name not in (_CACHE, _DEVICE) \
                        and name not in registry.slot_bands:
                    # default requirements follow the file's registry:
                    # a band the registry does not declare cannot be
                    # required (per-file overrides stay unconditional)
                    continue
                for band in registry.resolve((name,)):
                    if band in refs or (is_cache and generic):
                        continue
                    diags.append(make(
                        "B001", rel, info.node.lineno, info.qualname,
                        "%s:%s" % (verb, band),
                        "lifecycle verb %r does not propagate band "
                        "%r: every registered band/side-band must "
                        "survive this operation (reference it, or "
                        "iterate the band dict generically)"
                        % (verb, band)))
    for verb in REQUIRED_SITES.get(rel, ()):
        if verb not in seen_verbs:
            diags.append(make(
                "B001", rel, 1, "<module>", "missing-verb:%s" % verb,
                "lifecycle file carries no '# band-verb: %s' "
                "annotation — the %s propagation check is silently "
                "disabled" % (verb, verb)))


def _check_b002(infos, classes, registry, rel, diags):
    bands = set(registry.slot_bands)
    for info in infos:
        # _mark_dirty with a name outside the registry dirties nothing
        for sub in _walk_fn(info.node):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "_mark_dirty":
                for a in sub.args:
                    if isinstance(a, ast.Constant) \
                            and isinstance(a.value, str) \
                            and a.value not in bands:
                        diags.append(make(
                            "B002", rel, sub.lineno, info.qualname,
                            "unknown-band:%s" % a.value,
                            "_mark_dirty(%r) names no registered band "
                            "— the upload this meant to force never "
                            "happens" % a.value))
    for cls_name, methods in classes.items():
        if "_mark_dirty" not in methods:
            continue  # not a dirty-protocol class
        callers: Dict[str, Set[str]] = {}
        for name, info in methods.items():
            for callee in info.self_calls:
                callers.setdefault(callee, set()).add(name)
        for name, info in methods.items():
            if name == "__init__":
                continue  # construction writes every band by design
            for band, lineno in info.mutations:
                if _dirty_covered(band, info, methods, callers):
                    continue
                diags.append(make(
                    "B002", rel, lineno, info.qualname, band,
                    "host band mirror %r mutated without _mark_dirty/"
                    "device adoption on this path (or on every caller) "
                    "— the device copy silently keeps stale truth"
                    % band))


def _check_b003(infos, rel, diags):
    ser = [i for i in infos if "serialize" in i.verbs
           and i.schema is not None]
    imp = [i for i in infos if "import" in i.verbs
           and i.schema is not None]
    ser_full = set().union(*[i.schema for i in ser
                             if not i.schema_partial]) \
        if any(not i.schema_partial for i in ser) else set()
    imp_full = set().union(*[i.schema for i in imp
                             if not i.schema_partial]) \
        if any(not i.schema_partial for i in imp) else set()
    if ser_full and imp_full:
        for i in ser:
            if i.schema_partial:
                continue
            for key in sorted(i.schema - imp_full):
                diags.append(make(
                    "B003", rel, i.node.lineno, i.qualname,
                    "unread:%s" % key,
                    "record field %r is serialized but the import "
                    "side never reads it back — lost at every "
                    "handoff/restart" % key))
        for i in imp:
            if i.schema_partial:
                continue
            for key in sorted(i.schema - ser_full):
                diags.append(make(
                    "B003", rel, i.node.lineno, i.qualname,
                    "unwritten:%s" % key,
                    "import side reads record field %r that no "
                    "serialize side writes — KeyError (or a silent "
                    "default) on every real record" % key))
    if imp_full:
        for i in ser:
            if not i.schema_partial:
                continue
            for key in sorted(i.schema - imp_full):
                diags.append(make(
                    "B003", rel, i.node.lineno, i.qualname,
                    "unread:%s" % key,
                    "encoder rewrites field %r that the decoder "
                    "never reads back" % key))


def _check_b004(infos, registry, rel, diags):
    dev = registry.device_advanced
    bands = set(registry.slot_bands)
    if registry.slot_bands:
        for band in sorted(dev - bands):
            diags.append(make(
                "B004", rel, 1, "<module>",
                "device-advanced-drift:%s" % band,
                "_DEVICE_ADVANCED names %r which is not in _BANDS — "
                "the chain gate consults a band that cannot exist"
                % band))
    for info in infos:
        for sub in _walk_fn(info.node):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "difference_update" \
                    and isinstance(sub.func.value, ast.Attribute) \
                    and sub.func.value.attr == "_dirty":
                for a in sub.args:
                    vals = _str_tuple(a)
                    if vals is None:
                        continue
                    for v in vals:
                        if v not in dev:
                            diags.append(make(
                                "B004", rel, sub.lineno, info.qualname,
                                "adopt:%s" % v,
                                "dirty bit cleared for %r which the "
                                "compiled window does not advance — "
                                "a host change to it would never "
                                "re-upload" % v))
            elif isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for key in sorted(_dev_store_keys(targets)):
                    if info.node.name != "_band" and key not in dev:
                        diags.append(make(
                            "B004", rel, sub.lineno, info.qualname,
                            "adopt:%s" % key,
                            "device copy of %r adopted outside the "
                            "_band upload but it is not in "
                            "_DEVICE_ADVANCED — _can_chain cannot "
                            "see it go stale" % key))
            elif isinstance(sub, ast.BinOp) \
                    and isinstance(sub.op, ast.BitAnd):
                for side in (sub.left, sub.right):
                    vals = _str_tuple(side)
                    if vals is not None and set(vals) != set(dev) \
                            and _mentions_dirty(sub):
                        diags.append(make(
                            "B004", rel, sub.lineno, info.qualname,
                            "chain-gate:%s" % ",".join(sorted(vals)),
                            "chain gate intersects _dirty with a "
                            "literal band set != _DEVICE_ADVANCED — "
                            "the gate and the scan have drifted"))


def _mentions_dirty(binop) -> bool:
    for side in (binop.left, binop.right):
        if isinstance(side, ast.Attribute) and side.attr == "_dirty":
            return True
    return False


# --- entry points ------------------------------------------------------

def lint_file(path: str) -> List[Diagnostic]:
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    rel = rel_path(path)
    registry = _file_registry(tree, path)
    infos, classes = _harvest(tree, src, registry)
    diags: List[Diagnostic] = []
    _check_b001(infos, classes, registry, rel, diags)
    _check_b002(infos, classes, registry, rel, diags)
    _check_b003(infos, rel, diags)
    _check_b004(infos, registry, rel, diags)
    diags.sort(key=lambda d: (d.path, d.line, d.code, d.detail))
    return diags


def lint_paths(paths=None) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for f in walk_python_files(paths, DEFAULT_PATHS):
        diags.extend(lint_file(f))
    return diags
