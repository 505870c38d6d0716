"""Device helpers that keep the drivers' loops free of host reads: a
sync that also serves the CPU rehearsals, and a lag that holds the host
a few steps ahead of the card without draining its queue."""

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Lag(object):
    """Marks each enqueued step with an event and waits for the one
    `depth` steps back, so the host never runs more than `depth` steps
    ahead and the card never waits for the host's check of the clock."""

    def __init__(self, device, depth=2):
        self.cuda = torch.device(device).type == "cuda"
        self.depth = depth
        self.events = []

    def mark(self):
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.pop(0).synchronize()
