"""Training events delivered to user handlers (reference
python/paddle/v2/event.py)."""

__all__ = [
    "EndIteration",
    "BeginIteration",
    "BeginPass",
    "EndPass",
    "TestResult",
    "EndForwardBackward",
]


class WithMetric(object):
    def __init__(self, evaluator=None):
        self.evaluator = evaluator

    @property
    def metrics(self):
        if isinstance(self.evaluator, dict):
            return self.evaluator
        return {}


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost=None):
        super().__init__(evaluator)
        self.cost = cost


class BeginPass(object):
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None, gm=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.gm = gm


class BeginIteration(object):
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndForwardBackward(object):
    def __init__(self, pass_id, batch_id, gm=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.gm = gm


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator=None, gm=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.gm = gm
