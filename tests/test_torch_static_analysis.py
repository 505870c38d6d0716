"""The port's static analyzers (paddle_tpu_torch.analysis): the lock and
band lints against the JAX package's on every file fixture of
tests/test_static_analysis.py (each of those tests runs here with its
lint calls answered by both packages and compared), the port's own
sync-free and shard fixtures (a positive and a negative for each code),
the CLI's exit codes and refusals, the gate over the port with its
baseline — and the gate's teeth: a lock or a band dropped from a copy of
a port file is the one new finding. All on the CPU, no card."""

import inspect
import os
import shutil
import subprocess
import sys

import pytest

import test_static_analysis as corpus
from paddle_tpu.analysis import band_lint as jband
from paddle_tpu.analysis import diagnostics as jdiag
from paddle_tpu.analysis import lock_lint as jlock
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import __main__ as cli
from paddle_tpu_torch.analysis import (band_lint, diagnostics, lock_lint,
                                       shard_lint, trace_lint)

ROOT = diagnostics.repo_root()


def _sig(diags):
    return [(d.code, d.line, d.fingerprint) for d in diags]


def _file_fixture_tests():
    """The corpus tests that lint files they write under tmp_path with
    lock_lint or band_lint (not the CLI's subprocess runs)."""
    out = []
    for name, fn in sorted(vars(corpus).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        params = inspect.signature(fn).parameters
        src = inspect.getsource(fn)
        if "tmp_path" in params and "subprocess" not in src and any(
                s in src for s in ("_lock_codes", "_band_codes",
                                   "lock_lint.", "band_lint.")):
            out.append(name)
    return out


FIXTURE_TESTS = _file_fixture_tests()


def test_the_fixture_corpus_is_found():
    assert len(FIXTURE_TESTS) >= 30
    for name in ("test_l001_unguarded_mutation",
                 "test_l002_lock_order_inversion",
                 "test_l004_explicit_lock_condition",
                 "test_b001_cow_drops_scale_band",
                 "test_b001_missing_required_verb_annotation",
                 "test_b003_wire_schema_asymmetry",
                 "test_b004_adoption_and_gate_drift"):
        assert name in FIXTURE_TESTS


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_lock_and_band_lints_match_the_jax_lints(name, tmp_path,
                                                 monkeypatch):
    """One JAX corpus test, its lint calls answered by both packages:
    the same (code, line, fingerprint) on every file it lints."""
    seen = []

    def both(jmod, tmod):
        real = jmod.lint_file

        def lint_file(path):
            want = real(path)
            rel = jdiag.rel_path(path)
            if jmod is jband and rel in jband.REQUIRED_SITES:
                # the corpus names a temporary file a lifecycle file
                monkeypatch.setitem(band_lint.REQUIRED_SITES, rel,
                                    jband.REQUIRED_SITES[rel])
            got = tmod.lint_file(path)
            assert _sig(got) == _sig(want), path
            seen.append(path)
            return want

        monkeypatch.setattr(jmod, "lint_file", lint_file)

    both(jlock, lock_lint)
    both(jband, band_lint)
    fn = getattr(corpus, name)
    kwargs = {"tmp_path": tmp_path}
    if "monkeypatch" in inspect.signature(fn).parameters:
        kwargs["monkeypatch"] = monkeypatch
    fn(**kwargs)
    assert seen, "%s linted no file" % name


# ---------------------------------------------------------------------
# the port's own fixtures: sync-free (T) and shard (S) codes
# ---------------------------------------------------------------------

_TRACE_FIXTURES = {
    "T001": (
        "import torch\n"
        "def step(x, outs, meta: dict):  # sync-free\n"
        "    n = x.sum().item() + float(outs['loss'])\n"
        "    k = int(meta['k']) + int(outs.get('n'))\n"
        "    return _tail(x, n + k)\n"
        "def _tail(x, n):\n"
        "    return x * float(x.max())\n",
        "import numpy as np\n"
        "import torch\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._alive = np.zeros(4, bool)\n"
        "    def step(self, x, live: np.ndarray, attrs):  # sync-free\n"
        "        k = int(attrs.get('k', 1)) + len(live)\n"
        "        occ = float(self._alive.sum())\n"
        "        rows = [int(s) for s in live]\n"
        "        return x[:, :int(x.shape[1])] * k, occ, rows\n"
        "    def report(self, x):\n"
        "        return x.item()\n"),
    "T002": (
        "import random\n"
        "import torch\n"
        "def sample(logits):  # sync-free\n"
        "    noise = torch.rand(logits.shape)\n"
        "    return logits + noise * random.random()\n",
        "import torch\n"
        "def sample(logits, g):  # sync-free\n"
        "    return logits + torch.rand(logits.shape, generator=g)\n"),
    "T003": (
        "import torch\n"
        "def step(x, done):  # sync-free\n"
        "    if done:\n"
        "        return x\n"
        "    return x + 1\n",
        "import torch\n"
        "def step(x, ins, bias=None, rev: bool = False):  # sync-free\n"
        "    if bias is not None and x.ndim == 2 and ins.get('H0'):\n"
        "        x = x + bias\n"
        "    while x.shape[0] > 4 and not rev:\n"
        "        x = x[:4]\n"
        "    return x\n"),
    "T005": (
        "import torch\n"
        "class Fleet:\n"
        "    def _loop(self):  # thread: replica\n"
        "        self._tick()\n"
        "    def _tick(self):\n"
        "        self.probe = torch.zeros(4, device='cuda')\n",
        "import torch\n"
        "class Fleet:\n"
        "    def _loop(self):  # thread: replica\n"
        "        with torch.no_grad():\n"
        "            torch.cuda.set_device(0)\n"
        "            self.engine.step()\n"
        "    def warm(self):\n"
        "        return torch.zeros(4)\n"),
}

_SHARD_FIXTURES = {
    "S001": (
        "from paddle_tpu_torch.parallel.mesh import PartitionSpec as P\n"
        "from paddle_tpu_torch.parallel.collectives import MeshAxis\n"
        "def specs(mesh):\n"
        "    ax = MeshAxis.of(mesh, 'modle')\n"
        "    return P(None, 'model'), P(('data', 'exprt'),), ax\n",
        "from paddle_tpu_torch.parallel.mesh import (PartitionSpec as P,\n"
        "                                            make_mesh)\n"
        "from paddle_tpu_torch.parallel.collectives import MeshAxis\n"
        "def build():\n"
        "    return make_mesh({'data': 1, 'rows': 2})\n"
        "def specs(mesh, axis: str = 'stage'):\n"
        "    g = mesh.group(('data', 'rows'))\n"
        "    return (P(None, 'rows'), P('dcn_data'), MeshAxis.of(mesh, axis),\n"
        "            MeshAxis.of(mesh, 'stage'), g, [1, 2].index(2))\n"),
    "S003": (
        "import numpy as np\n"
        "class Fleet:\n"
        "    def _loop(self):  # thread: replica\n"
        "        self._peek()\n"
        "    def _peek(self):\n"
        "        tok = self.engine._band('tok')\n"
        "        return tok.cpu(), float(self._dev['pos'].sum())\n",
        "import numpy as np\n"
        "class Engine:\n"
        "    def _loop(self):  # thread: replica\n"
        "        return np.asarray(self._tok)\n"
        "    def step(self):\n"
        "        return self._band('tok').cpu()\n"),
    "S004": (
        "import torch\n"
        "from paddle_tpu_torch.parallel.mesh import P, shard_parameter\n"
        "def place(fluid):\n"
        "    w = fluid.layers.create_parameter(shape=[64, 32],\n"
        "                                      dtype='float32')\n"
        "    shard_parameter(w, P(None, 'model', None))\n"
        "    b = torch.zeros((8,)).reshape(2, 4)\n"
        "    shard_parameter(b, P('data', None, None))\n",
        "import torch\n"
        "from paddle_tpu_torch.parallel.mesh import P, shard_parameter\n"
        "def place(fluid, w):\n"
        "    v = fluid.layers.create_parameter(shape=[64, 32],\n"
        "                                      dtype='float32')\n"
        "    shard_parameter(v, P(None, 'model'))\n"
        "    shard_parameter(w, P('data', None, None))\n"
        "    shard_parameter(torch.zeros(4, 8), P('data'))\n"),
}

# the findings each positive fixture must give, exactly
_WANT = {
    "T001": [("T001", "step", ".item"), ("T001", "step", "float"),
             ("T001", "step", "int"), ("T001", "step", "int"),
             ("T001", "_tail", "float")],
    "T002": [("T002", "sample", "torch.rand"),
             ("T002", "sample", "random.random")],
    "T003": [("T003", "step", "done")],
    "T005": [("T005", "Fleet._tick", "torch.zeros")],
    "S001": [("S001", "specs", "modle"), ("S001", "specs", "exprt")],
    "S003": [("S003", "Fleet._peek", "_dev"),
             ("S003", "Fleet._peek", "_dev")],
    "S004": [("S004", "place", "rank2-spec3"),
             ("S004", "place", "rank2-spec3")],
}


def _lint(tmp_path, mod, name, src):
    f = tmp_path / ("%s.py" % name)
    f.write_text(src)
    return mod.lint_file(str(f))


@pytest.mark.parametrize("code,positive", [
    (c, p) for c in sorted(_TRACE_FIXTURES) + sorted(_SHARD_FIXTURES)
    for p in (True, False)])
def test_port_fixture(tmp_path, code, positive):
    fixtures, mod = (_TRACE_FIXTURES, trace_lint) if code[0] == "T" \
        else (_SHARD_FIXTURES, shard_lint)
    src = fixtures[code][0 if positive else 1]
    diags = _lint(tmp_path, mod, code.lower(), src)
    got = sorted((d.code, d.symbol, d.detail) for d in diags)
    assert got == (sorted(_WANT[code]) if positive else []), \
        [diagnostics.format_diag(d) for d in diags]


def test_sync_free_roots_propagate_to_local_callees(tmp_path):
    # the root's same-module callee is linted with it; a function no
    # root reaches is not, and `self.m()` is not resolved
    src = ("import torch\n"
           "def helper(x):\n"
           "    return x.tolist()\n"
           "def unreached(x):\n"
           "    return x.item()\n"
           "class E:\n"
           "    def step(self, x):  # sync-free\n"
           "        self.other(x)\n"
           "        return [helper(r) for r in x]\n"
           "    def other(self, x):\n"
           "        return x.cpu()\n")
    diags = _lint(tmp_path, trace_lint, "prop", src)
    assert [(d.code, d.symbol) for d in diags] == [("T001", "helper")]


def test_codes_without_counterpart_are_named():
    assert set(jdiag.CODES) <= set(diagnostics.CODES)
    assert set(diagnostics.NO_COUNTERPART) == {"T004", "S002"}
    assert diagnostics.REPO_SCOPE_CODES == jdiag.REPO_SCOPE_CODES
    assert set(jdiag.CODES) - set(diagnostics.NO_COUNTERPART) >= {
        "T001", "T002", "T003", "T005", "S001", "S003", "S004"}


def test_public_names_cover_the_jax_package():
    import paddle_tpu.analysis as janalysis

    assert set(janalysis.__all__) <= set(analysis.__all__)
    for name in analysis.__all__:
        assert hasattr(analysis, name), name


# ---------------------------------------------------------------------
# port paths only: no constant of the port's analyzers names a JAX file
# ---------------------------------------------------------------------

def _path_constants():
    out = list(lock_lint.DEFAULT_PATHS) + list(trace_lint.HOT_PATHS) \
        + list(band_lint.DEFAULT_PATHS) + list(shard_lint.DEFAULT_PATHS)
    out += [path for path, _verb in band_lint.FILE_VERB_BANDS]
    out += list(band_lint.REQUIRED_SITES)
    out += [band_lint._ENGINE_FILE, band_lint._CACHE_FILE]
    return out


@pytest.mark.parametrize("path", sorted(set(_path_constants())))
def test_analyzer_paths_name_the_port(path):
    assert path.startswith("paddle_tpu_torch/"), path
    assert os.path.exists(os.path.join(ROOT, path)), path


def test_every_annotated_file_is_linted():
    """Every port file carrying `# guarded-by:`, `# band-verb:` or
    `# sync-free` annotations (after code, on its line) is linted by
    the analyzer that reads them (the analyzers' own docstrings aside)."""
    lock_files = {diagnostics.rel_path(p) for p in
                  diagnostics.walk_python_files(None,
                                                lock_lint.DEFAULT_PATHS)}
    want = {"guarded-by:": lock_files,
            "band-verb:": set(band_lint.DEFAULT_PATHS),
            "sync-free": set(trace_lint.HOT_PATHS)}
    docs = {"paddle_tpu_torch/analysis/%s.py" % m for m in
            ("__init__", "lock_lint", "band_lint", "trace_lint")}
    found = {mark: set() for mark in want}
    for path in diagnostics.walk_python_files(None, ["paddle_tpu_torch"]):
        rel = diagnostics.rel_path(path)
        if rel in docs:
            continue
        for line in open(path):
            code, sep, comment = line.partition("#")
            for mark in want:
                if sep and code.strip() and mark in comment:
                    found[mark].add(rel)
    for mark, files in found.items():
        assert files and files <= want[mark], (mark, files - want[mark])
    assert len(found["guarded-by:"]) >= 15


def test_sync_free_roots_are_the_cards_sync_checked_functions():
    """The `# sync-free` roots are exactly the functions chip_smoke.py
    runs under set_sync_debug_mode("error"), each named beside its
    phase there."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    roots = set()
    for path in trace_lint.HOT_PATHS:
        for q in trace_lint.sync_free_roots(os.path.join(ROOT, path)):
            roots.add("%s::%s" % (path, q))
    assert roots == set(chip_smoke.SYNC_FREE_ROOTS)
    assert len(roots) >= 2
    watch = inspect.getsource(chip_smoke._watch_steady_dispatch)
    lstm = inspect.getsource(chip_smoke.phase_lstm_sync)
    assert "eng._launch_window" in watch and "set_sync_debug_mode" in watch
    assert 'get_kernel("lstm")' in lstm and "set_sync_debug_mode" in lstm


# ---------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------

def test_port_is_clean_modulo_baseline():
    new, old, stale = analysis.run_all()
    assert new == [], "new static-analysis findings:\n" + "\n".join(
        diagnostics.format_diag(d) for d in new)
    assert stale == [], "stale baseline entries: %r" % stale
    assert sorted({d.fingerprint for d in old}) == sorted(
        analysis.load_baseline())


def test_run_all_without_programs_scopes_stale(tmp_path):
    # without the program entries a P-code baseline entry is out of
    # scope, never stale
    bl = tmp_path / "bl.txt"
    bl.write_text("P001 <x>::block0::op:ghost  # program-scope entry\n"
                  + "".join("%s  # kept\n" % fp
                            for fp in analysis.load_baseline()))
    new, _old, stale = analysis.run_all(baseline_path=str(bl),
                                        with_programs=False)
    assert new == [] and stale == []
    new, _old, stale = analysis.run_all(baseline_path=str(bl))
    assert new == [] and stale == ["P001 <x>::block0::op:ghost"]


BASELINE = analysis.load_baseline()


@pytest.mark.parametrize("fp", sorted(BASELINE))
def test_baseline_entry_is_justified(fp):
    why = BASELINE[fp]
    assert why and "TODO" not in why, fp
    # each is the counterpart of a JAX baseline entry, kept with the
    # JAX justification where the port copied the design
    jax_fp = fp.replace("paddle_tpu_torch/", "paddle_tpu/", 1)
    assert jdiag.load_baseline().get(jax_fp) == why, fp


def _drilled_copy(tmp_path, monkeypatch, rel, old, new, extra=()):
    """A copy of the port files `rel` (+ `extra`) under tmp_path, laid
    out as in the repo, with `old` replaced by `new` in `rel`; the
    analyzers anchored at tmp_path, so their fingerprints are the
    repo's."""
    for r in (rel,) + tuple(extra):
        dst = tmp_path / r
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(ROOT, r), dst)
    path = tmp_path / rel
    src = path.read_text()
    assert src.count(old) == 1, "drill site moved in %s" % rel
    path.write_text(src.replace(old, new))
    monkeypatch.setattr(diagnostics, "repo_root", lambda: str(tmp_path))
    monkeypatch.setattr(band_lint, "repo_root", lambda: str(tmp_path))
    return str(path)


def _gate_on(paths, lint):
    return analysis.split_new(lint.lint_paths(paths), BASELINE)


def test_gate_catches_a_dropped_lock(tmp_path, monkeypatch):
    rel = "paddle_tpu_torch/serving/kv_store.py"
    new, _old, _stale = _gate_on([os.path.join(ROOT, rel)], lock_lint)
    assert new == []
    path = _drilled_copy(
        tmp_path, monkeypatch, rel,
        "        with self._lock:\n"
        "            if self._file is not None:\n"
        "                self._file.close()\n"
        "                self._file = None\n",
        "        if self._file is not None:\n"
        "            self._file.close()\n"
        "            self._file = None\n")
    new, _old, _stale = _gate_on([path], lock_lint)
    assert [d.fingerprint for d in new] == [
        "L001 %s::KVBlockStore.close::_file" % rel]


def test_gate_catches_a_dropped_band(tmp_path, monkeypatch):
    rel = "paddle_tpu_torch/serving/engine.py"
    path = _drilled_copy(
        tmp_path, monkeypatch, rel,
        "            for buf in kv.values():\n"
        "                raw = raw_bytes(buf)\n",
        "            for buf in (kv['k'], kv['v'], kv['k_scale']):\n"
        "                raw = raw_bytes(buf)\n",
        extra=("paddle_tpu_torch/models/transformer.py",))
    new, _old, _stale = _gate_on([path], band_lint)
    assert [d.fingerprint for d in new] == [
        "B001 %s::ServingEngine._cow::cow:v_scale" % rel]


def test_band_registry_is_the_ports():
    reg = band_lint.load_registry()
    assert "tok" in reg.slot_bands and "tables" in reg.slot_bands
    assert reg.device_advanced <= set(reg.slot_bands)
    assert set(reg.cache_bands) == {"k", "v", "k_scale", "v_scale"}
    assert set(reg.slot_bands) == set(jband.load_registry().slot_bands)


# ---------------------------------------------------------------------
# the CLI, in process (one subprocess proves `python -m` itself)
# ---------------------------------------------------------------------

_L001_SRC = corpus._L001_SRC


def _main(capsys, *argv):
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_all_exits_zero_in_a_fresh_interpreter():
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--all"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new" in proc.stdout and "0 stale" in proc.stdout


@pytest.mark.parametrize("cmd", ["locks", "bands", "shard", "trace"])
def test_cli_analyzer_exits_zero(capsys, cmd):
    rc, out, _err = _main(capsys, cmd)
    assert rc == 0, out
    assert "0 new" in out and "0 stale" in out


def test_cli_write_baseline_refuses_partial_clobber(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text(_L001_SRC)
    with pytest.raises(SystemExit) as ei:
        cli.main(["--write-baseline", "locks", str(f)])
    assert ei.value.code == 2
    assert "clobber" in capsys.readouterr().err
    # two mutation sites share one fingerprint: one entry each
    f.write_text(_L001_SRC + "    def add2(self, x):\n"
                             "        self.items.append(x)\n"
                             "        self.items.append(x)\n")
    own = tmp_path / "own_baseline.txt"
    rc, _out, _err = _main(capsys, "--baseline", str(own),
                           "--write-baseline", "locks", str(f))
    assert rc == 0
    lines = [l for l in own.read_text().splitlines()
             if l and not l.startswith("#")]
    assert len(lines) == 2 and all("L001" in l and "TODO" in l
                                   for l in lines)


@pytest.mark.parametrize("cmd", ["trace", "locks", "bands", "shard"])
def test_cli_bad_path_is_usage_error(tmp_path, capsys, cmd):
    rc, _out, err = _main(capsys, cmd, str(tmp_path / "missing.py"))
    assert rc == 2 and "no such file" in err
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    rc, _out, err = _main(capsys, cmd, str(broken))
    assert rc == 2 and "Traceback" not in err


def test_cli_fails_on_todo_justification(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text(_L001_SRC)
    fp = lock_lint.lint_file(str(f))[0].fingerprint
    bl = tmp_path / "bl.txt"
    bl.write_text("%s  # TODO: justify or fix\n" % fp)
    rc, out, _err = _main(capsys, "--baseline", str(bl), "locks", str(f))
    assert rc == 1 and "unjustified baseline entry" in out


def test_cli_nonzero_on_fresh_finding(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text(_L001_SRC)
    rc, out, _err = _main(capsys, "locks", str(f))
    assert rc == 1 and "L001" in out


def test_cli_partial_path_run_skips_stale_check(capsys):
    rc, out, _err = _main(capsys, "locks",
                          os.path.join(ROOT, "paddle_tpu_torch", "data"))
    assert rc == 0, out
    assert "stale baseline entry" not in out and "0 stale" in out


def test_cli_nonzero_on_stale_entry_within_scope(tmp_path, capsys):
    bl = tmp_path / "bl.txt"
    bl.write_text(
        "".join("%s  # kept\n" % fp for fp in BASELINE
                if fp.startswith("L"))
        + "L001 gone.py::C.add::items  # fixed long ago\n"
        + "T003 other.py::f::x  # belongs to the trace analyzer\n")
    rc, out, _err = _main(capsys, "--baseline", str(bl), "locks")
    assert rc == 1
    assert "0 new" in out and "L001 gone.py" in out
    assert "T003 other.py" not in out


def test_cli_program_verifies_guarded_own_programs(tmp_path, capsys):
    entry = tmp_path / "train.py"
    entry.write_text(
        "from paddle_tpu_torch import fluid\n"
        "main, startup = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(main, startup):\n"
        "    x = fluid.layers.data('x', shape=[4], dtype='float32')\n"
        "b = main.global_block()\n"
        "b.create_var(name='out', shape=(4,), dtype='float32')\n"
        "b.append_op('elementwise_add',\n"
        "            inputs={'X': ['x'], 'Y': ['ghost']},\n"
        "            outputs={'Out': ['out']})\n")
    rc, out, _err = _main(capsys, "program", str(entry), "--fetch", "out")
    assert rc == 1 and "P001" in out and "ghost" in out
    empty = tmp_path / "empty.py"
    empty.write_text("x = 1\n")
    rc, _out, err = _main(capsys, "program", str(empty))
    assert rc == 2 and "no non-empty Program" in err


def test_cli_bands_baseline_suppression_and_scoping(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text(corpus._BAND_REG + (
        "class E:\n"
        "    def _mark_dirty(self, *names):\n"
        "        self._dirty.update(names or _BANDS)\n"
        "    def bump(self, s):\n"
        "        self._counts[s] += 1\n"))
    fp = band_lint.lint_file(str(f))[0].fingerprint
    bl = tmp_path / "bl.txt"
    bl.write_text("%s  # corpus defect kept on purpose\n"
                  "S001 gone.py::f::modle  # other analyzer's entry\n" % fp)
    rc, out, _err = _main(capsys, "--baseline", str(bl), "bands", str(f))
    assert rc == 0, out
    assert "0 new" in out and "0 stale" in out


def test_cli_journal_and_explore(tmp_path, capsys):
    rc, _out, err = _main(capsys, "journal", str(tmp_path / "none.jsonl"))
    assert rc == 2 and "error" in err
    rc, _out, err = _main(capsys, "explore", "--scenario", "nope")
    assert rc == 2 and "unknown scenario" in err
    with pytest.raises(SystemExit) as ei:
        cli.main(["explore", "--replay", "main"])
    assert ei.value.code == 2
    # the port's explorer and journal verifier behind the CLI: the
    # schedules' journals pass the DFA, closed
    jdir = tmp_path / "journals"
    rc, out, _err = _main(capsys, "explore", "--scenario", "submit_kill",
                          "--max-schedules", "2", "--journal-dir",
                          str(jdir))
    assert rc == 0 and "no violation" in out
    journals = sorted(jdir.glob("*.jsonl"))
    assert journals
    rc, out, _err = _main(capsys, "journal", str(journals[0]),
                          "--expect-closed")
    assert rc == 0 and "0 new" in out
    rc, out, _err = _main(capsys, "explore", "--scenario", "submit_kill",
                          "--replay", "main")
    assert rc == 0 and "0 violation" in out
