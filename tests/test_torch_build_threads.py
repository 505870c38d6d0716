"""The port's kernel build and launch counters under threads: a fleet's
replica threads make their first kernel calls together, so the build
must compile each source once and every launch must be counted. Runs on
the CPU with a stand-in for nvcc (a script that sleeps, then writes its
-o target) and stubbed launches."""

import os
import stat
import sys
import threading

import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.parallel import flash_attention as tfa
from paddle_tpu_torch.parallel import kernel_utils
from paddle_tpu_torch.parallel import paged_attention as tpa

FAKE_NVCC = '''#!%s
import sys, time
args = sys.argv[1:]
with open(%r, "a") as f:
    f.write("compile\\n")
time.sleep(0.5)
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(b"not a library")
print("fake ptxas report")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    count = tmp_path / "compiles.txt"
    script = tmp_path / "nvcc"
    script.write_text(FAKE_NVCC % (sys.executable, str(count)))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return count


def _together(n, fn):
    """Run fn() in n threads released at once; re-raise the first error."""
    start = threading.Barrier(n)
    out, errs = [None] * n, []

    def run(i):
        start.wait()
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return out


def test_four_threads_build_one_library_once(fake_nvcc):
    paths = _together(4, lambda: _build.build(["paged_attention"]))
    assert fake_nvcc.read_text().splitlines() == ["compile"]
    assert len({p["paged_attention"] for p in paths}) == 1
    lib = paths[0]["paged_attention"]
    assert os.path.exists(lib) and open(lib, "rb").read() == b"not a library"
    assert open(lib + ".log").read().strip() == "fake ptxas report"
    # no temporary file is left behind, and a later call compiles nothing
    assert not [f for f in os.listdir(os.path.dirname(lib))
                if f.endswith(".tmp")]
    _build.build(["paged_attention"])
    assert fake_nvcc.read_text().splitlines() == ["compile"]


def test_bind_once_binds_once_across_threads():
    calls = []

    def binder():
        calls.append(1)
        threading.Event().wait(0.2)
        return object()

    bound = kernel_utils.bind_once(binder)
    got = _together(4, bound)
    assert len(calls) == 1 and len({id(g) for g in got}) == 1
    assert bound() is got[0]


@pytest.fixture
def stub_launch(monkeypatch):
    """The paged wrappers take their launch branch on CPU tensors, with
    the launch itself stubbed out: only the counting is exercised."""
    monkeypatch.setattr(tpa, "on_cpu", lambda what, *ts: False)
    monkeypatch.setattr(
        tpa, "_launch", lambda q, *a, **kw: torch.zeros(q.shape))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    yield
    sys.setswitchinterval(old)


@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
def test_launch_counters_stay_exact_under_threads(stub_launch, which):
    wrapper = getattr(tpa, "paged_%s_attention" % which)
    q = torch.zeros(1, 1, 1, 1)
    pool = torch.zeros(1, 1, 1, 1)
    table = torch.zeros(1, 1, dtype=torch.int32)
    start = 0 if which == "prefill" else torch.zeros(1, dtype=torch.int32)
    args = (q[0] if which == "prefill" else q, pool, pool,
            table[0] if which == "prefill" else table, start)
    before = tpa.launches[which]
    _together(4, lambda: [wrapper(*args) for _ in range(1000)])
    assert tpa.launches[which] - before == 4000
    tpa.launches[which] = before


@pytest.mark.parametrize("kvq,dtype", [("int8", torch.int8),
                                       ("fp8", torch.float8_e4m3fn)])
def test_quantized_launches_count_apart_by_pool(stub_launch, kvq, dtype):
    q = torch.zeros(1, 1, 1, 1)
    pool = torch.zeros(1, 1, 1, 1, dtype=dtype)
    scale = torch.ones(1, 1)
    table = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    sc = dict(k_scale=scale, v_scale=scale)
    before = dict(tpa.launches)
    before_q = {k: dict(v) for k, v in tpa.quant_launches.items()}
    _together(4, lambda: [
        (tpa.paged_decode_attention(q[:, 0], pool, pool, table, pos, **sc),
         tpa.paged_prefill_attention(q[0], pool, pool, table[0], 0, **sc))
        for _ in range(250)])
    # an unquantized pool counts in `launches` only
    tpa.paged_verify_attention(q, q, q, table, pos)
    assert {k: tpa.launches[k] - before[k] for k in before} == {
        "decode": 1000, "verify": 1, "prefill": 1000}
    for name, counts in tpa.quant_launches.items():
        n = 1000 if name == kvq else 0
        assert {k: counts[k] - before_q[name][k] for k in counts} == {
            "decode": n, "verify": 0, "prefill": n}
    tpa.launches.update(before)
    for name, counts in before_q.items():
        tpa.quant_launches[name].update(counts)


def test_flash_counters_stay_exact_under_threads():
    before = dict(tfa.launches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(4, lambda: [kernel_utils.count_launch(tfa.launches, k)
                              for _ in range(1000)
                              for k in ("forward", "backward_q")])
    finally:
        sys.setswitchinterval(old)
    assert tfa.launches["forward"] - before["forward"] == 4000
    assert tfa.launches["backward_q"] - before["backward_q"] == 4000
    assert tfa.launches["backward_kv"] == before["backward_kv"]
    tfa.launches.update(before)
