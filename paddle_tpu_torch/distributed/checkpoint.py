"""Durable training checkpoints: CRC-checked, atomic, shard-aware
(counterpart of paddle_tpu/distributed/checkpoint.py, in its on-disk
format: a checkpoint written by either package loads in the other).

Go pserver parity (go/pserver/service.go:120-226,346): state is written
with CRC32 sidecars and the metadata commit is one atomic rename, so a
half-written checkpoint is never visible and a corrupt shard is rejected
at load. Serves the legacy trainer's save_dir / init_model_path with
optimizer state included — resume is exact.

Sharded state: on the port's mesh executor (parallel/mesh.py, one
process per rank) a parameter with a spec lives in the scope as this
rank's block (`Scope.set_shard`). Each rank writes only the blocks it
owns — the first replica of each — with the block's global index in its
own per-process meta, as the JAX package writes the shards of a sharded
jax.Array; values every rank holds whole are written once, by rank 0.
Loading merges ALL process metas found in the directory and reassembles
each entry's global value, so a checkpoint taken on N ranks restores on
any rank count. Process index and count are the torch.distributed
rank and world size (0 and 1 outside a world).

Values are written as numpy arrays: a device tensor is copied to the
host first (bfloat16 as float32, numpy having no bfloat16).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
import sys
import zlib

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "retain",
           "resume_or_init", "verify_checkpoint", "verify_step"]

_LOG = logging.getLogger(__name__)

_STEP_DIR_RE = re.compile(r"^step_(\d+)$")


def _step_dir(dirname: str, step: int) -> str:
    return os.path.join(dirname, "step_%010d" % int(step))


def _list_step_dirs(dirname: str):
    """[(step, path)] of step-keyed subdirectories, newest first."""
    out = []
    try:
        names = os.listdir(dirname)
    except OSError:
        return out
    for n in names:
        m = _STEP_DIR_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(dirname, n)))
    out.sort(reverse=True)
    return out


def _metas_complete(metas) -> bool:
    if not metas:
        return False
    expected = max(m.get("process_count", 1) for m in metas)
    return len(metas) >= expected


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _meta_name(pidx=None) -> str:
    return "checkpoint.meta.p%d.json" % (
        _process_index() if pidx is None else pidx
    )


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _fname(name: str, pidx: int, shard: int = None) -> str:
    base = name.replace("/", "__")
    if shard is None:
        return "%s.p%d.npy" % (base, pidx)
    return "%s.p%d.s%d.npy" % (base, pidx, shard)


def _atomic_save(dirname: str, fname: str, arr: np.ndarray):
    tmp = os.path.join(dirname, fname + ".tmp")
    with open(tmp, "wb") as fh:  # np.save(path) would append ".npy"
        np.save(fh, np.ascontiguousarray(arr))
    os.replace(tmp, os.path.join(dirname, fname))


def _host(val) -> np.ndarray:
    """A scope value as a host array of its own (a tensor through the
    executor's `as_numpy`, which copies)."""
    import torch

    from ..fluid.executor import as_numpy

    if isinstance(val, torch.Tensor):
        return as_numpy(val)
    return np.array(val, copy=True)


def _snapshot(scope):
    """What this process writes of `scope`, on the host: name -> ("whole",
    array) or ("shard", block, global index, global shape). A block is
    written by the first replica that holds it only; a whole value on a
    world of several processes by rank 0 only (every rank holds the
    same consensus value)."""
    shards = getattr(scope, "_shards", {})
    many = _process_count() > 1
    out = {}
    for name in sorted(scope.keys()):
        val = scope.get(name)
        if val is None:
            continue
        info = shards.get(name)
        if info is not None:
            mesh, split = info
            others = [a for a in mesh.axis_names if a not in split.axes]
            if any(mesh.coords[a] != 0 for a in others):
                continue  # another rank holds this same block
            arr = _host(val)
            n, i = mesh.extent(split.axes), mesh.index(split.axes)
            size = arr.shape[split.dim]
            gshape = list(arr.shape)
            gshape[split.dim] = size * n
            index = [[0, d] for d in gshape]
            index[split.dim] = [i * size, (i + 1) * size]
            out[name] = ("shard", arr, index, gshape)
        elif not many or _process_index() == 0:
            out[name] = ("whole", _host(val))
    return out


def _write(snap, dirname: str, step: int, extra: dict, keep_last: int,
           protect):
    """Write a snapshot as one committed step (see save_checkpoint)."""
    root = dirname
    dirname = _step_dir(dirname, step)
    os.makedirs(dirname, exist_ok=True)
    pidx = _process_index()
    entries = {}
    for name, rec in snap.items():
        arr = rec[1]
        if rec[0] == "shard":
            fname = _fname(name, pidx, 0)
            _atomic_save(dirname, fname, arr)
            entries[name] = {
                "sharded": True,
                "global_shape": list(rec[3]),
                "dtype": str(arr.dtype),
                "shards": [{"file": fname, "crc32": _crc(arr),
                            "index": rec[2]}],
            }
        else:
            fname = _fname(name, pidx)
            _atomic_save(dirname, fname, arr)
            entries[name] = {
                "file": fname,
                "crc32": _crc(arr),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
    meta = {
        "step": int(step),
        "process": pidx,
        "process_count": _process_count(),
        "entries": entries,
        "extra": extra,
    }
    tmp = os.path.join(dirname, _meta_name() + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(dirname, _meta_name()))
    meta["dir"] = dirname
    _prune_old_steps(root, keep=keep_last, protect=protect)
    return meta


def _extra(extra, stateful):
    extra = dict(extra or {})
    if stateful:
        extra["stateful"] = {
            name: obj.state_dict() for name, obj in stateful.items()
        }
    return extra


def save_checkpoint(scope, dirname: str, step: int = 0, extra: dict = None,
                    keep_last: int = 1, stateful: dict = None,
                    protect=None):
    """Write every scope entry (params + optimizer state + BN stats) under
    `dirname/step_<N>/`. Safe against interruption: data files land first,
    then the meta file commits the checkpoint with one atomic rename — and
    because every step gets its own subdirectory, a crash mid-save never
    touches the last committed step (Go pserver keeps its last good
    checkpoint the same way, service.go:346). Older steps are pruned only
    after the new step's metas are complete. Sharded values: this rank
    saves only the blocks it owns (see the module docstring).

    `stateful` maps names to objects with a JSON-serializable
    `state_dict()` (a data loader cursor, an LR schedule, ...);
    their states commit atomically with the tensors and are restored by
    load_checkpoint/resume_or_init(stateful=...) — so a supervisor
    restart resumes the input pipeline at the exact record the model
    state was checkpointed at."""
    return _write(_snapshot(scope), dirname, step, _extra(extra, stateful),
                  keep_last, protect)


def _protect_set(protect):
    if protect is None:
        return frozenset()
    if isinstance(protect, (list, tuple, set, frozenset)):
        return frozenset(int(p) for p in protect if p is not None)
    return frozenset([int(protect)])


def _prune_old_steps(root: str, keep: int = 1, protect=None):
    """Remove step directories older than the newest COMPLETE step (all
    expected process metas committed), keeping `keep` complete steps.
    Steps in `protect` (the sentinel's known-good step) are never
    removed and never consume the keep budget. Racing deleters (every
    process prunes after its own save) are harmless: rmtree errors are
    ignored."""
    protect = _protect_set(protect)
    steps = _list_step_dirs(root)
    complete_seen = 0
    for s, path in steps:  # newest first
        if s in protect:
            continue  # known-good: the rollback target outlives GC
        if _metas_complete(_dir_metas(path)):
            complete_seen += 1
            if complete_seen > keep:
                shutil.rmtree(path, ignore_errors=True)
        elif complete_seen >= keep:
            # an older incomplete step can never become complete again
            shutil.rmtree(path, ignore_errors=True)


def retain(dirname: str, keep_last: int = 1, protect=None):
    """Garbage-collect old checkpoint steps under `dirname`, keeping the
    newest `keep_last` COMPLETE steps (plus any newer still-incomplete
    save in flight). A crash-looping worker checkpoints every restart
    cycle; without GC its disk fills exactly when the job is least
    healthy — the supervisor calls this after every restart. `protect`
    (a step or list of steps — the sentinel's last known-good) is
    exempt from collection, so a divergence rollback always finds its
    target on disk. Returns the steps still on disk, newest first."""
    if keep_last < 1:
        raise ValueError("retain(keep_last=%d): must keep >= 1" % keep_last)
    _prune_old_steps(dirname, keep=keep_last, protect=protect)
    return [s for s, _ in _list_step_dirs(dirname)]


def _verify_step_dir(path: str):
    """Re-check one step directory offline: metas complete, every
    referenced shard file present, readable, and matching its recorded
    CRC32. Returns (ok, problems) where `problems` names each failure
    (which entry, which file, which CRC) — the evidence trail a resume
    fallback logs and the `verify` CLI prints."""
    problems = []
    metas = _dir_metas(path)
    if not metas:
        return False, ["no committed meta files"]
    if not _metas_complete(metas):
        expected = max(m.get("process_count", 1) for m in metas)
        return False, [
            "incomplete: %d of %d process meta file(s) present"
            % (len(metas), expected)]
    latest = max(m["step"] for m in metas)
    for m in metas:
        if m["step"] != latest:
            continue
        for name in sorted(m["entries"]):
            ent = m["entries"][name]
            shards = ent["shards"] if ent.get("sharded") else [ent]
            for sh in shards:
                fp = os.path.join(path, sh["file"])
                if not os.path.exists(fp):
                    problems.append(
                        "entry %r: missing file %s" % (name, sh["file"]))
                    continue
                try:
                    arr = np.load(fp)
                except Exception as e:  # torn header, truncation, ...
                    problems.append(
                        "entry %r: unreadable %s (%s: %s)"
                        % (name, sh["file"], type(e).__name__, e))
                    continue
                got = _crc(arr)
                if got != sh["crc32"]:
                    problems.append(
                        "entry %r: CRC mismatch in %s (recorded %d, "
                        "file has %d)" % (name, sh["file"],
                                          sh["crc32"], got))
    return not problems, problems


def verify_step(dirname: str, step: int):
    """Verify ONE step directory under `dirname` — metas complete,
    every shard file present, readable, CRC-matching. This is exactly
    the per-candidate check `resume_or_init`'s walk-back runs before
    trusting a checkpoint; exposed so other consumers (the serving
    fleet's `roll_weights` — no replica may touch a candidate weight
    set before its CRC walk passes) share the same verification
    instead of re-deriving it. Returns (ok, problems)."""
    path = _step_dir(dirname, int(step))
    if not os.path.isdir(path):
        return False, ["no such checkpoint step dir: %s" % path]
    return _verify_step_dir(path)


def verify_checkpoint(dirname: str):
    """Offline integrity scan of every step directory under `dirname`
    (or of `dirname` itself for the legacy flat layout): re-checks all
    shard CRCs and metas-completeness WITHOUT loading anything into a
    scope. Returns [{"step", "dir", "ok", "problems"}, ...] oldest
    first — run it in CI or before committing to a long resume:

        python -m paddle_tpu_torch.distributed.checkpoint verify <dir>
    """
    steps = _list_step_dirs(dirname)
    if not steps:
        if _dir_metas(dirname):
            ok, problems = _verify_step_dir(dirname)
            return [{"step": None, "dir": dirname, "ok": ok,
                     "problems": problems}]
        return []
    out = []
    for s, path in sorted(steps):
        ok, problems = _verify_step_dir(path)
        out.append({"step": s, "dir": path, "ok": ok,
                    "problems": problems})
    return out


def _quarantine_step_dir(path: str):
    """Set a failed step dir aside as `<dir>.corrupt` — NEVER deleted
    (it is the forensic evidence of what tore), never seen by resume
    again (the step-dir regex no longer matches it). Returns the new
    path, or None when a racing resume already moved it."""
    target = path + ".corrupt"
    n = 1
    while os.path.exists(target):
        target = path + ".corrupt.%d" % n
        n += 1
    try:
        os.replace(path, target)
    except OSError:
        return None
    return target


def resume_or_init(scope, dirname: str, init_fn=None, strict: bool = True,
                   stateful: dict = None, step: int = None):
    """One-call crash-recovery glue for supervised workers: restore the
    newest VERIFIABLE checkpoint under `dirname` into `scope` and return
    its merged meta, or — when nothing restorable is committed (first
    launch, or a crash before the first save) — run `init_fn()` and
    return None. The caller branches on the return value for its start
    step:

        meta = resume_or_init(scope, ckpt_dir, init_fn=run_startup)
        start = meta["step"] + 1 if meta else 0

    Hardened against torn/corrupted checkpoints (zero manual
    intervention): each candidate step dir is verified (metas complete +
    every shard CRC) BEFORE loading; a failing dir is renamed
    `<dir>.corrupt` (kept, never deleted), the failure logged with the
    exact CRC that mismatched, and the walk continues to the next older
    step. Exception: on a MULTI-process job a metas-incomplete dir is
    skipped without renaming — it may be a peer's save still in flight,
    and destroying it would crash healthy writers. Fallbacks taken are
    recorded in the returned meta under `"fallbacks"`. The verification
    pass reads every array once more than a blind load would — the
    price of never resuming from a dir a later CRC failure would have
    killed anyway.

    `step` pins the restore target (the sentinel's known-good step):
    newer step dirs are ignored outright — they are not corrupt, just
    distrusted — and the walk starts at `step`, still falling back past
    corruption below it.

    `stateful` objects (see save_checkpoint) get `load_state_dict()`
    called with their checkpointed state on the restore path; on the
    init path they are left at their constructed state.
    """
    fallbacks = []
    if dirname:
        for s, path in _list_step_dirs(dirname):  # newest first
            if step is not None and s > int(step):
                continue
            ok, problems = _verify_step_dir(path)
            if not ok:
                incomplete = any(p.startswith("incomplete")
                                 for p in problems)
                if incomplete and _process_count() > 1:
                    # multi-process job: an incomplete newest step may
                    # be a PEER's save still in flight — renaming it
                    # would destroy a checkpoint about to commit. Skip
                    # non-destructively (the pre-hardening behavior);
                    # only a single-process resume, where no peer can
                    # be writing, quarantines incomplete dirs.
                    _LOG.warning(
                        "resume: skipping incomplete checkpoint step "
                        "%d at %s (%s) — possibly a peer's in-flight "
                        "save", s, path, "; ".join(problems))
                    fallbacks.append({"step": s, "dir": path,
                                      "renamed_to": None,
                                      "problems": problems})
                    continue
                renamed = _quarantine_step_dir(path)
                _LOG.warning(
                    "resume: checkpoint step %d at %s failed "
                    "verification (%s)%s — falling back to the next "
                    "older step", s, path, "; ".join(problems),
                    (", quarantined as %s" % renamed) if renamed else "")
                fallbacks.append({"step": s, "dir": path,
                                  "renamed_to": renamed,
                                  "problems": problems})
                continue
            meta = load_checkpoint(scope, dirname, strict=strict,
                                   stateful=stateful, step=s)
            if fallbacks:
                meta["fallbacks"] = fallbacks
            return meta
        if _dir_metas(dirname):  # legacy flat layout
            meta = load_checkpoint(scope, dirname, strict=strict,
                                   stateful=stateful)
            if fallbacks:
                meta["fallbacks"] = fallbacks
            return meta
        if fallbacks:
            # nothing restorable: the operator must still learn WHICH
            # checkpoints were quarantined before training restarts
            # from scratch
            _LOG.error(
                "resume: no verifiable checkpoint under %s — %d step "
                "dir(s) failed verification (%s); initializing fresh",
                dirname, len(fallbacks),
                "; ".join(f["problems"][0] for f in fallbacks))
    if init_fn is not None:
        init_fn()
    return None


def _dir_metas(dirname: str):
    metas = []
    for path in sorted(glob.glob(os.path.join(dirname, "checkpoint.meta.p*.json"))):
        m = re.search(r"checkpoint\.meta\.p(\d+)\.json$", path)
        if not m:
            continue
        with open(path) as f:
            metas.append(json.load(f))
    return metas


def _resolve_dir(dirname: str, strict: bool = True, step: int = None):
    """Pick the directory holding the checkpoint to load: the newest
    step_<N>/ subdir whose metas are complete (falling back to older
    complete steps), or `dirname` itself for the legacy flat layout.
    With `step`, exactly that step's dir — incomplete is an error (the
    caller asked for a specific rollback target)."""
    if step is not None:
        path = _step_dir(dirname, step)
        metas = _dir_metas(path)
        if not _metas_complete(metas):
            raise IOError(
                "checkpoint step %d under %s is missing or incomplete"
                % (int(step), dirname))
        return path, metas
    newest_partial = None
    for s, path in _list_step_dirs(dirname):
        metas = _dir_metas(path)
        if _metas_complete(metas):
            return path, metas
        if metas and newest_partial is None:
            newest_partial = (path, metas)
    if newest_partial is not None and not strict:
        return newest_partial
    if newest_partial is not None and strict:
        path, metas = newest_partial
        expected = max(m.get("process_count", 1) for m in metas)
        raise IOError(
            "newest checkpoint step under %s was written by %d processes "
            "but only %d meta file(s) are present (and no older complete "
            "step exists)" % (dirname, expected, len(metas))
        )
    return dirname, _dir_metas(dirname)  # legacy flat layout


def latest_step(dirname: str):
    """Highest COMMITTED step — the one load_checkpoint would restore
    (complete metas only; a partially-written newer step is ignored)."""
    try:
        _, metas = _resolve_dir(dirname, strict=True)
    except IOError:
        return None  # only a partial step exists: nothing committed
    return max((m["step"] for m in metas), default=None)


def _load_entry(dirname: str, name: str, ent: dict, strict: bool):
    if ent.get("sharded"):
        out = np.zeros(ent["global_shape"], ent["dtype"])
        covered = np.zeros(ent["global_shape"], bool)
        for sh in ent["shards"]:
            path = os.path.join(dirname, sh["file"])
            if not os.path.exists(path):
                if strict:
                    raise FileNotFoundError(path)
                return None
            arr = np.load(path)
            if _crc(arr) != sh["crc32"]:
                raise IOError(
                    "checkpoint shard %r failed its CRC check (%s)"
                    % (name, path)
                )
            idx = tuple(slice(a, b) for a, b in sh["index"])
            out[idx] = arr
            covered[idx] = True
        if not covered.all():
            # a writer's meta is missing (non-shared filesystem, lost
            # file): silent zero-filled regions would be the worst kind
            # of corruption
            raise IOError(
                "checkpoint entry %r is only partially covered by the "
                "shards on disk (%d of %d elements); a process's shard "
                "files/meta are missing from %s"
                % (name, int(covered.sum()), covered.size, dirname)
            )
        return out
    path = os.path.join(dirname, ent["file"])
    if not os.path.exists(path):
        if strict:
            raise FileNotFoundError(path)
        return None
    arr = np.load(path)
    if _crc(arr) != ent["crc32"]:
        raise IOError(
            "checkpoint entry %r failed its CRC check (corrupt file %s)"
            % (name, path)
        )
    return arr


def load_checkpoint(scope, dirname: str, strict: bool = True,
                    stateful: dict = None, step: int = None) -> dict:
    """Restore a checkpoint into `scope`, verifying every CRC (reference
    LoadCheckpoint rejects corrupt shards).

    Merges ALL per-process metas of the newest complete step directory
    (falling back to older complete steps when the newest save was
    interrupted; legacy flat-layout directories still load): a sharded
    entry is reassembled from every process's shard files (requires a
    shared or gathered filesystem, as the reference's save_dir does).
    Entries are restored as host numpy values; the executor re-places
    them onto the current mesh/shardings at the next run — so a
    checkpoint written on N processes restores on any process count.
    Returns the merged meta (step = max across processes; entries =
    union). `step` pins the load to one step dir (rollback to
    known-good) instead of the newest complete one."""
    dirname, metas = _resolve_dir(dirname, strict=strict, step=step)
    if not metas:
        raise FileNotFoundError(
            "no checkpoint meta found under %s" % dirname
        )
    # only metas from the LATEST committed step participate: a resume on
    # fewer processes overwrites only its own meta files, and mixing a
    # stale process's older-step meta in would restore stale shard data
    latest = max(m["step"] for m in metas)
    metas = [m for m in metas if m["step"] == latest]
    expected = max(m.get("process_count", 1) for m in metas)
    if strict and len(metas) < expected:
        raise IOError(
            "checkpoint at step %d was written by %d processes but only "
            "%d meta file(s) are present under %s (incomplete copy?)"
            % (latest, expected, len(metas), dirname)
        )
    merged = {
        "step": latest,
        "dir": dirname,
        "extra": {},
        "entries": {},
    }
    partial = {}  # sharded entries may span processes: merge shard lists
    for m in metas:
        merged["extra"].update(m.get("extra") or {})
        for name, ent in m["entries"].items():
            if ent.get("sharded"):
                agg = partial.setdefault(
                    name,
                    {
                        "sharded": True,
                        "global_shape": ent["global_shape"],
                        "dtype": ent["dtype"],
                        "shards": [],
                    },
                )
                if not agg.get("sharded"):
                    raise IOError(
                        "checkpoint entry %r is sharded in one process "
                        "meta and whole in another — corrupt checkpoint "
                        "directory" % name
                    )
                agg["shards"].extend(ent["shards"])
            else:
                prev = partial.get(name)
                if prev is not None and prev.get("sharded"):
                    raise IOError(
                        "checkpoint entry %r is sharded in one process "
                        "meta and whole in another — corrupt checkpoint "
                        "directory" % name
                    )
                partial[name] = ent
    for name, ent in partial.items():
        val = _load_entry(dirname, name, ent, strict)
        if val is not None:
            scope.set(name, val)
            merged["entries"][name] = ent
    if stateful:
        states = merged["extra"].get("stateful") or {}
        for name, obj in stateful.items():
            if name in states:
                obj.load_state_dict(states[name])
            elif strict:
                raise KeyError(
                    "stateful object %r has no state in the checkpoint "
                    "under %s" % (name, dirname))
    return merged


# ---------------------------------------------------------------------
# async save: snapshot now, write in the background. Preemption-aware
# training wants the step loop paused only for the device->host pull,
# not for CRC + disk + rename (the reference's Go pserver likewise
# checkpoints off the serving path, service.go:120).
# ---------------------------------------------------------------------


class AsyncCheckpoint(object):
    """Handle for an in-flight save: result() joins and re-raises any
    writer error; done() polls. thread=None marks an already-committed
    save (the synchronous fallback)."""

    def __init__(self, thread, box):
        self._thread = thread
        self._box = box

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def result(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("checkpoint writer still running")
        if self._box.get("error") is not None:
            raise self._box["error"]
        return self._box.get("value")


def save_checkpoint_async(scope, dirname: str, step: int = 0,
                          extra: dict = None,
                          keep_last: int = 1,
                          stateful: dict = None,
                          protect=None) -> AsyncCheckpoint:
    """Snapshot the scope to host memory NOW (so later training steps —
    the optimizer updates the scope's tensors in place — cannot touch
    the saved values), then run the normal atomic save on a background
    thread. Returns an AsyncCheckpoint; call result() before relying on
    the checkpoint.

    `stateful` objects have their state_dict() taken NOW too, so a
    loader that keeps delivering batches while the writer runs cannot
    leak post-snapshot positions into the checkpoint. `protect` (the
    sentinel's known-good step) is honored by the background prune
    exactly as in the synchronous saver. Each rank of a mesh snapshots
    and writes its own blocks, with no traffic between ranks, so a
    sharded save is asynchronous too.
    """
    import threading

    extra = _extra(extra, stateful)
    # device -> host copies happen here, synchronously
    snap = _snapshot(scope)
    box = {"value": None, "error": None}

    def _run():
        try:
            _write(snap, dirname, step, extra, keep_last, protect)
            box["value"] = _step_dir(dirname, step)
        except BaseException as e:  # surfaced by result()
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    return AsyncCheckpoint(t, box)


__all__ += ["save_checkpoint_async", "AsyncCheckpoint"]


# ---------------------------------------------------------------------
# offline integrity scanner CLI:
#   python -m paddle_tpu_torch.distributed.checkpoint verify <dir>
# walks every step dir, re-checks every shard CRC + metas-complete,
# prints per-step verdicts, exits non-zero on any failure — usable in
# CI and before committing a long job to a resume.
# ---------------------------------------------------------------------


def _cli(argv):
    if len(argv) != 2 or argv[0] != "verify":
        sys.stderr.write(
            "usage: python -m paddle_tpu_torch.distributed.checkpoint "
            "verify <checkpoint-dir>\n")
        return 2
    dirname = argv[1]
    if not os.path.isdir(dirname):
        sys.stderr.write("verify: %s is not a directory\n" % dirname)
        return 2
    reports = verify_checkpoint(dirname)
    if not reports:
        sys.stderr.write("verify: no checkpoint steps under %s\n" % dirname)
        return 1
    bad = 0
    for r in reports:
        label = ("step %d" % r["step"]) if r["step"] is not None \
            else "flat layout"
        if r["ok"]:
            print("OK    %-12s %s" % (label, r["dir"]))
        else:
            bad += 1
            print("FAIL  %-12s %s" % (label, r["dir"]))
            for p in r["problems"]:
                print("        %s" % p)
    print("%d step(s) checked, %d failed" % (len(reports), bad))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
