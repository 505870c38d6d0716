"""Dataset reader creators (counterpart of paddle_tpu/v2/dataset; reference
python/paddle/v2/dataset/*).

The reference downloads real corpora into ~/.cache/paddle/dataset; this
package downloads nothing, so each module serves a deterministic
synthetic corpus with the exact record shapes, vocab APIs and reader-
creator signatures of the original, and decodes the real files when
they are placed in the cache (`common.DATA_HOME`). Every module gives
the JAX package's records. The image modules (`flowers`, `voc2012`)
import PIL only inside the functions that decode images."""

from . import (  # noqa: F401
    cifar,
    criteo,
    common,
    conll05,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_housing,
    voc2012,
    wmt14,
    wmt16,
)

__all__ = [
    "mnist", "cifar", "imdb", "imikolov", "movielens", "uci_housing",
    "wmt14", "wmt16", "conll05", "sentiment", "flowers", "voc2012",
    "mq2007", "criteo", "common",
]
