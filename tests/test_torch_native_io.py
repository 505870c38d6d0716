"""The port's native record files (paddle_tpu_torch.native) against the JAX
package's (paddle_tpu.native): the two share recordio.cc's format, so a
file written by either package reads in the other, byte for byte, and
both stop at the same record on a torn tail or a corrupt record. Record
streams match exactly: there is no tolerance."""

import pickle

import numpy as np
import pytest

import paddle_tpu.native as jnative
import paddle_tpu_torch.native as tnative
from torch_native_build import ensure_jax_native

SIDES = {"jax": jnative, "torch": tnative}
DIRECTIONS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]


@pytest.fixture(autouse=True)
def _jax_native_built():
    """Every test here may load the JAX package's library: build it
    first, once, safely beside other test processes."""
    ensure_jax_native()


def _records(seed, n=120):
    """Seeded pickled instance tuples of varied length."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append(pickle.dumps((i, rng.randn(int(rng.randint(0, 40)))
                                 .astype(np.float32))))
    return out


def _write(native, path, recs):
    with native.RecordWriter(path) as w:
        for r in recs:
            w.write(r)


def test_both_writers_make_the_same_bytes(tmp_path):
    recs = _records(0)
    for side, native in SIDES.items():
        _write(native, str(tmp_path / (side + ".rio")), recs)
    assert (tmp_path / "jax.rio").read_bytes() == \
        (tmp_path / "torch.rio").read_bytes()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_records_cross_read(tmp_path, writer, reader):
    """read_records and the prefetch queue of one package yield exactly
    the records the other package wrote, over several files."""
    recs = [_records(1), _records(2, n=30)]
    paths = []
    for k, rs in enumerate(recs):
        paths.append(str(tmp_path / ("f%d.rio" % k)))
        _write(SIDES[writer], paths[-1], rs)
    r = SIDES[reader]
    assert list(r.read_records(paths[0])) == recs[0]
    assert list(r.PrefetchReader(paths, capacity=7)) == recs[0] + recs[1]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_torn_tail_stops_alike(tmp_path, writer, reader):
    """A writer crash mid-record: both readers deliver every whole record
    before the torn one (test_native_io.py's drill, across packages)."""
    p = tmp_path / "t.rio"
    recs = [pickle.dumps(i) for i in range(100)]
    _write(SIDES[writer], str(p), recs)
    p.write_bytes(p.read_bytes()[:-5])
    got = list(SIDES[reader].read_records(str(p)))
    assert got == list(jnative.read_records(str(p))) == recs[:99]
    assert list(SIDES[reader].PrefetchReader([str(p)])) == recs[:99]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_corrupt_record_stops_alike(tmp_path, writer, reader):
    """A flipped payload byte fails the record's CRC: both readers stop
    before it, at the same record."""
    p = tmp_path / "c.rio"
    recs = [pickle.dumps(i) for i in range(10)]
    _write(SIDES[writer], str(p), recs)
    raw = bytearray(p.read_bytes())
    raw[20] ^= 0xFF
    p.write_bytes(bytes(raw))
    got = list(SIDES[reader].read_records(str(p)))
    assert got == list(jnative.read_records(str(p)))
    assert len(got) < 10 and got == recs[:len(got)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_empty_record_is_read_by_the_port(tmp_path, writer):
    """A zero-length record is well formed (its header carries length 0
    and the CRC of nothing): the port's readers deliver it and the
    records after it, from a file either package wrote. The JAX
    package's readers take it for the end of the stream (rio_next and
    pq_next return 0 for both there): that fault of the reference is
    pinned here, so a change to either side shows."""
    p = str(tmp_path / "e.rio")
    _write(SIDES[writer], p, [b"a", b"", b"b"])
    assert list(tnative.read_records(p)) == [b"a", b"", b"b"]
    assert list(tnative.PrefetchReader([p])) == [b"a", b"", b"b"]
    assert list(tnative.PrefetchReader([p, p], capacity=1)) == \
        [b"a", b"", b"b"] * 2
    assert list(jnative.read_records(p)) == [b"a"]
    assert list(jnative.PrefetchReader([p])) == [b"a"]


def test_prefetch_close_stops_the_native_thread(tmp_path):
    """close() on a prefetcher whose bounded queue is full ends its
    thread; a closed reader stays exhausted."""
    p = str(tmp_path / "big.rio")
    _write(tnative, p, [b"x" * 64] * 500)
    r = tnative.PrefetchReader([p], capacity=2)
    assert next(r) == b"x" * 64
    r.close()
    assert list(r) == []


def test_no_toolchain_raises_with_no_fallback(tmp_path, monkeypatch):
    """Where the library cannot be built, every entry point raises: there
    is no Python reader in its place."""
    import subprocess

    def no_gxx(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(subprocess, "run", no_gxx)
    assert tnative.available() is False
    with pytest.raises(RuntimeError, match="native build failed earlier"):
        tnative.RecordWriter(str(tmp_path / "x.rio"))
    with pytest.raises(RuntimeError):
        list(tnative.read_records(str(tmp_path / "x.rio")))
