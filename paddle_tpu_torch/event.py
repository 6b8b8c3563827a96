"""Training events. Counterpart of ``paddle_tpu/event.py``, the same
classes with the same fields.

``SGD.train`` drives an event handler with these marker objects so a
user script can log, test, checkpoint or plot mid-training without
touching the loop.
"""


class WithMetric:
    def __init__(self, metrics):
        # metrics: dict name -> float (evaluator results for the span)
        self.metrics = dict(metrics or {})


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, metrics=None, interrupted=False):
        super().__init__(metrics)
        self.pass_id = pass_id
        # True when a graceful shutdown (SIGTERM/SIGINT or a fault-plan
        # preemption) cut the pass short: metrics cover only the completed
        # iterations and a final checkpoint was written
        self.interrupted = interrupted


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, metrics=None,
                 batch_size=None, host_wall_s=None, device_wall_s=None,
                 mfu=None):
        super().__init__(metrics)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        # rows in the just-trained minibatch (None when len() cannot see
        # through what the reader yields)
        self.batch_size = batch_size
        # the step's wall split (seconds): host-side dispatch and feed vs
        # time blocked on device results; and its model-FLOPs utilisation
        # when the trainer's GoodputMeter priced the program (never yet
        # in the port: ROADMAP item 9). All optional.
        self.host_wall_s = host_wall_s
        self.device_wall_s = device_wall_s
        self.mfu = mfu


class TestResult(WithMetric):
    def __init__(self, cost, metrics=None):
        super().__init__(metrics)
        self.cost = cost
