"""paddle.v2.master.client shim (counterpart of paddle_tpu/v2/master;
reference python/paddle/v2/master/client.py:29 wrapping the Go master
via a cgo shim). Backed by the Coordinator (paddle_tpu_torch.distributed)
— same task-lease semantics, no etcd/Go."""

from __future__ import annotations

from typing import List, Optional

from ...distributed import Coordinator

__all__ = ["client"]


class client(object):
    """API-shaped like the reference: set_dataset(paths), next_record().

    `etcd_endpoints` of the form "host:port" connects to a Coordinator
    service (distributed/coordinator.py RemoteCoordinator) so multiple
    workers share one task queue; anything else gets a private
    in-process Coordinator (single-worker / tests)."""

    def __init__(self, etcd_endpoints=None, timeout_sec=60, buf_size=32):
        addr = etcd_endpoints if isinstance(etcd_endpoints, str) else None
        if addr and ":" in addr.rsplit("/", 1)[-1]:
            from ...distributed.coordinator import RemoteCoordinator

            self._coordinator = RemoteCoordinator(
                addr.rsplit("/", 1)[-1], timeout_s=timeout_sec
            )
        else:
            self._coordinator = Coordinator(timeout_s=timeout_sec)
        self._iter = None
        self._pass = 0

    def set_dataset(self, paths: List[str]):
        self._coordinator.set_dataset(list(paths))

    def _records(self):
        # the offset-aware lease loop (skip records a previous holder
        # already delivered, report the offset + fencing token on
        # failure) lives in ONE place: MasterClient. task_failed used to
        # re-lease the WHOLE chunk, replaying every record delivered
        # before the error.
        from ..reader import creator
        from ...distributed.coordinator import MasterClient

        return iter(MasterClient(
            self._coordinator,
            lambda payload: creator.recordio([payload])(),
            epoch_limit=self._pass,
        ))

    def next_record(self) -> Optional[bytes]:
        """One raw record, None at pass end (reference returns (r, err));
        the next call after a pass end starts the NEXT pass (epoch
        rollover in the coordinator's queue)."""
        if self._iter is None:
            self._iter = self._records()
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = None
            self._pass += 1
            return None

    def paddle_start_get_records(self, pass_id):
        self._pass = int(pass_id)
        self._iter = self._records()
