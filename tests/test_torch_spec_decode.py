"""Speculative decoding in the port's engine against the JAX engine, and
its invariants.

* Spec K=4 traces (unquantized and int8 KV) through the JAX engine
  (gather form) and the port: the same tokens and finish reasons, greedy
  and sampled, the same per-step trajectory, prefix hits, copy-on-writes
  and spec counters (windows, drafted, accepted).
* Within one quantization setting, spec decoding emits the plain
  path's tokens: the row-commit scale rule keeps rejected drafts out of
  every block scale.
* Knob refusals: spec with a decode window or async dispatch, and a
  negative window, raise ValueError; K < 2 is plain decode.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.serving import ServingEngine
from torch_parity import drive, models, tokens_of, trace

torch.set_num_threads(2)

ENGINE = dict(max_slots=3, kv_block_tokens=8, prefill_chunk_tokens=8,
              prefix_cache_tokens=64, kv_pool_blocks=13,
              max_prefills_per_step=2, spec_draft_len=4)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spec_engine_matches_jax_engine(kv_quant):
    jcfg, jp, cfg, tp = models(0)
    reqs = trace(0)
    cow_prompt = np.random.RandomState(1).randint(0, 50, 24).astype(np.int32)
    jeng = JaxEngine(jp, jcfg, paged_kernel="gather", kv_quant=kv_quant,
                     **ENGINE)
    teng = ServingEngine(tp, cfg, device="cpu", kv_quant=kv_quant, **ENGINE)
    jout, jtraj = drive(jeng, reqs, cow_prompt)
    tout, ttraj = drive(teng, reqs, cow_prompt)
    assert tout == jout
    assert ttraj == jtraj
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for key in ("spec_windows", "spec_drafted", "spec_accepted",
                "spec_accept_rate", "cow_blocks", "decode_steps",
                "prefill_tokens_computed", "kv_quant"):
        assert trep[key] == jrep[key], key
    assert trep["prefix_cache"]["hits"] == jrep["prefix_cache"]["hits"] >= 2
    assert trep["spec_accepted"] > 0  # the repeated text drafted tokens
    assert trep["spec_verify_steps"] == trep["decode_steps"] \
        == jeng.metrics.decode_steps


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8"])
def test_spec_tokens_equal_plain_tokens(kv_quant):
    """Greedy and sampled, the verify path emits exactly what the plain
    decode path emits for the same quantization setting."""
    _, _, cfg, tp = models(7)
    reqs = trace(7)
    out = {}
    for spec in (None, 4):
        eng = ServingEngine(tp, cfg, device="cpu", max_slots=2,
                            kv_block_tokens=8, prefill_chunk_tokens=8,
                            prefix_cache_tokens=128, spec_draft_len=spec,
                            kv_quant=kv_quant)
        out[spec] = tokens_of(eng, reqs)
        if spec:
            assert eng.metrics.spec_accepted > 0
            assert eng.metrics.report()["spec_verify_steps"] \
                == eng.metrics.decode_steps > 0
        else:
            assert eng.metrics.report()["spec_verify_steps"] == 0
    assert out[4] == out[None]


def test_spec_knobs():
    _, _, cfg, tp = models(2)
    for knob in ({"decode_window": 8}, {"async_dispatch": True}):
        with pytest.raises(ValueError, match="spec_draft_len composes"):
            ServingEngine(tp, cfg, device="cpu", spec_draft_len=4, **knob)
    with pytest.raises(ValueError, match="spec_draft_len"):
        ServingEngine(tp, cfg, device="cpu", spec_draft_len=-1)
    eng = ServingEngine(tp, cfg, device="cpu", spec_draft_len=1)
    assert eng.spec_draft_len is None
    h = eng.submit(np.arange(5), 4)
    eng.run()
    assert len(h.tokens) == 4 and eng.metrics.spec_windows == 0
