"""Serving integrity sentinel (counterpart of
paddle_tpu/serving/integrity.py): `IntegrityError`, the per-engine
`ServingSentinel`, KV block fingerprints and the known-answer canary's
golden trace.

  in-step numeric TRAPS   every decode (each iteration of a decode
                          window) and every final prefill chunk also
                          computes a per-slot non-finite trap over its
                          logits (`transformer.logits_trap`: logits
                          plus the softmax denominator) and a
                          max-|logit| scalar (`transformer.logit_amax`).
                          A tripped slot becomes an `IntegrityError`
                          instead of an emitted token; with
                          `spike_factor` set, the scalar feeds the
                          shared EWMA/hysteresis `TripDetector`.
  KV block FINGERPRINTS   a folded f32 checksum per physical block
                          (`transformer.paged_block_fingerprint`),
                          committed when a block closes (published into
                          the prefix trie), verified when an aliased
                          block is re-opened by another request, and
                          dropped when the block is freed
                          (`BlockFingerprints`).
  CANARY golden trace     `golden_trace`: the greedy tokens the port's
                          own `generate` gives on a fixed prompt, the
                          known answer a live engine is checked
                          against.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import torch

from ..models import transformer as tlm
from ..utils.detector import TripDetector

__all__ = ["IntegrityError", "BlockFingerprints", "ServingSentinel",
           "golden_trace", "fp_digest", "CANARY_PROMPT"]

# the default known-answer canary prompt: tiny, fixed, and in every
# model's vocab range (ids 1..3)
CANARY_PROMPT = (1, 2, 3)

# relative tolerance of a fingerprint comparison: the recompute runs the
# same reduction on the same device, so a clean block matches to the
# bit; the slack only forgives float noise far below any corruption
_FP_RTOL = 1e-5


class IntegrityError(RuntimeError):
    """A serving engine produced evidence of silent corruption. `kind`
    is "trap" | "fingerprint" | "spike" (a fleet adds "canary");
    `replica` names the tripped replica when known."""

    def __init__(self, msg: str, kind: str = "trap", replica=None):
        super().__init__(msg)
        self.kind = kind
        self.replica = replica


class BlockFingerprints(object):
    """Host bookkeeping of per-physical-block checksums (engine state,
    thread-confined like the allocator). COMMITTED when a block closes,
    VERIFIED when an aliased block is re-opened, DROPPED when the block
    returns to the free list (a recycled id must never be judged against
    its previous tenant's checksum)."""

    def __init__(self):
        self._fp: Dict[int, float] = {}  # guarded-by: scheduler
        self.committed = 0               # guarded-by: scheduler
        self.verified = 0                # guarded-by: scheduler
        self.mismatches = 0              # guarded-by: scheduler

    def commit(self, bid: int, fp: float):
        if bid not in self._fp:
            self.committed += 1
        self._fp[int(bid)] = float(fp)

    def expected(self, bid: int) -> Optional[float]:
        return self._fp.get(int(bid))

    def drop(self, bid: int):
        self._fp.pop(int(bid), None)

    def check(self, bid: int, got: float) -> bool:
        """Compare a recomputed fingerprint against the committed one;
        True = clean (or never committed — nothing to judge)."""
        exp = self._fp.get(int(bid))
        if exp is None:
            return True
        self.verified += 1
        ok = abs(float(got) - exp) <= _FP_RTOL * max(1.0, abs(exp))
        if not ok:
            self.mismatches += 1
        return ok

    def stats(self) -> dict:
        return {"blocks_fingerprinted": len(self._fp),
                "committed": self.committed,
                "verified": self.verified,
                "mismatches": self.mismatches}


class ServingSentinel(object):
    """Folds one step's trap flag and max-|logit| scalar into a verdict:

    observe(trap_any, scale) -> "ok" | "trap" | "spike"

    The trap is a hard verdict; the scale feeds the spike detector only
    when `spike_factor` is set (magnitudes vary honestly across
    workloads, so the soft detector is opt-in)."""

    def __init__(self, spike_factor: Optional[float] = None,
                 hysteresis: int = 2, warmup: int = 8):
        self.detector = (
            TripDetector(spike_factor=float(spike_factor),
                         hysteresis=hysteresis, warmup=warmup)
            if spike_factor is not None else None)  # guarded-by: scheduler
        self.trips = 0  # guarded-by: scheduler

    def observe(self, trap_any: bool, scale: float) -> str:
        if trap_any:
            self.trips += 1
            return "trap"
        if self.detector is not None and scale > 0.0:
            if self.detector.observe(scale) != "ok":
                # "nonfinite" on the scale means the trap already fired
                # upstream in practice; fold both into the spike verdict
                self.trips += 1
                return "spike"
        return "ok"


def fp_digest(fps) -> str:
    """Fold a sequence of block fingerprints into one short hex digest:
    crc32 over each value's little-endian f64 bytes, chained (explicit
    endianness, so it is stable across platforms and bit-equal to the
    JAX package's)."""
    acc = 0
    for fp in fps:
        acc = zlib.crc32(struct.pack("<d", float(fp)), acc)
    return "%08x" % (acc & 0xFFFFFFFF)


def golden_trace(params, cfg, prompt=CANARY_PROMPT, max_new_tokens=4):
    """The canary's golden GENERATED tokens for one weight set: greedy
    `transformer.generate` of the port on the canary prompt, on the
    device the parameters live on. Greedy engine output equals
    `generate()`, so an engine whose canary disagrees is emitting
    corrupt tokens. Returns a list of ints (the generated suffix)."""
    dev = params["embed"].device
    p = torch.tensor([list(prompt)], dtype=torch.int64, device=dev)
    out = tlm.generate(params, p, cfg, int(max_new_tokens))
    return [int(t) for t in out[0, p.shape[1]:].tolist()]
