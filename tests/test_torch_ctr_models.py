"""The port's CTR models (`paddle_tpu_torch.models.ctr`: Wide&Deep and
DeepFM) against the JAX package's on the CPU, at
tests/test_ctr_models.py's widths (6 fields, vocab 64, batch 32,
embeddings 8, deep layers (32, 16), Adam(0.01)) and synthetic
parity-plus-interaction labels: the same program built by each
package's fluid API trains from the same JAX startup weights
(tests/torch_parity.py `FluidPair`), with and without a dense input.

Tolerances: the 12-step loss sequences within rtol 2e-5 (the JAX
suite's bar for its mesh-vs-single-device check); the parameters
carried across by name (`wide_table`, `deep_table`, `fm_table`,
`fm_w_table`, `deep_fc0_w`, `dfm_fc0_w`, ...)."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from paddle_tpu.models import ctr as jctr
from paddle_tpu_torch.models import ctr as tctr
from torch_parity import JF, TF

torch.set_num_threads(2)

FIELDS, VOCAB, BATCH, DENSE = 6, 64, 32, 4
NAMES = {"wide_deep": ("wide_table", "deep_table", "deep_fc0_w",
                       "deep_fc1_w", "deep_out_w"),
         "deepfm": ("fm_w_table", "fm_table", "dfm_fc0_w", "dfm_fc1_w",
                    "dfm_out_w")}


def synthetic(seed=0, n=BATCH, dense=False):
    """tests/test_ctr_models.py's data: labels follow field 0's id parity
    xor an interaction of fields 1 and 2, with 10% noise."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (n, FIELDS)).astype(np.int64)
    signal = (ids[:, 0] % 2) ^ ((ids[:, 1] % 2) & (ids[:, 2] % 2))
    noise = rng.rand(n) < 0.1
    feed = dict(ids=ids,
                y=(signal ^ noise).astype(np.float32).reshape(n, 1))
    if dense:
        feed["dense"] = rng.randn(n, DENSE).astype(np.float32)
    return feed


def program(kind, dense):
    def build(fluid, resnet):
        ctr = jctr if fluid is JF else tctr
        ids = fluid.layers.data(name="ids", shape=[FIELDS], dtype="int64")
        label = fluid.layers.data(name="y", shape=[1], dtype="float32")
        dense_in = fluid.layers.data(name="dense", shape=[DENSE],
                                     dtype="float32") if dense else None
        loss, prob = getattr(ctr, kind)(ids, label, num_fields=FIELDS,
                                        vocab=VOCAB, embed_dim=8,
                                        deep_dims=(32, 16),
                                        dense_input=dense_in)
        auc = fluid.layers.auc(input=prob, label=label)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return dict(loss=loss, auc=auc)
    return build


@pytest.mark.parametrize("dense", [False, True], ids=["ids", "dense_input"])
@pytest.mark.parametrize("kind", ["wide_deep", "deepfm"])
def test_ctr_loss_sequence_matches_jax(kind, dense):
    pair = tp.FluidPair(program(kind, dense))
    for name in NAMES[kind]:  # the parameters pair up by name
        assert pair.names[name] == name
    feed = synthetic(dense=dense)
    runs = [pair.run(feed, ["loss", "auc"]) for _ in range(12)]
    jl = [float(j[0][0]) for j, _ in runs]
    tl = [float(t[0][0]) for _, t in runs]
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    np.testing.assert_allclose([t[1] for _, t in runs],
                               [j[1] for j, _ in runs], rtol=0, atol=1e-6)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("kind", ["wide_deep", "deepfm"])
def test_ctr_trains(kind):
    """The port alone, 60 steps from its own startup: the loss halves."""
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        loss = program(kind, False)(TF, None)["loss"]
    with TF.scope_guard(TF.Scope()):
        exe = TF.Executor(TF.CPUPlace())
        exe.run(startup)
        feed = synthetic()
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                  for _ in range(60)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
