"""v2 trainer. Counterpart of ``paddle_tpu/v2/trainer.py`` (reference
python/paddle/v2/trainer.py:24 SGD): the cost/parameters/update_equation
constructor and the event-driven train(reader, num_passes,
event_handler, feeding) loop, run by the port's executor."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .. import event as evt
from ..data_feeder import DataFeeder


class SGD:
    def __init__(self, cost, parameters, update_equation,
                 extra_layers=None, is_local=True, accumulate_steps=1):
        """``accumulate_steps`` > 1: every k reader batches apply as ONE
        optimizer step on the mean gradient (in-graph gradient
        accumulation, optimizer.Optimizer.minimize)."""
        self.cost = cost
        self.parameters = parameters
        self.extra_layers = list(extra_layers or [])
        update_equation.minimize(
            cost, startup_program=parameters.startup_program,
            accumulate_steps=accumulate_steps)

    def _feeder(self, feeding: Optional[Dict[str, int]]):
        return DataFeeder(self.parameters.data_vars(feeding))

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None):
        event_handler = event_handler or (lambda e: None)
        self.parameters.init()
        feeder = self._feeder(feeding)
        exe, scope = self.parameters.executor, self.parameters.scope
        fetch = [self.cost] + self.extra_layers
        for pass_id in range(num_passes):
            event_handler(evt.BeginPass(pass_id))
            costs = []
            for batch_id, batch in enumerate(reader()):
                event_handler(evt.BeginIteration(pass_id, batch_id))
                out = exe.run(self.parameters.main_program,
                              feed=feeder.feed(batch), fetch_list=fetch,
                              scope=scope)
                cost = float(np.asarray(out[0]))
                costs.append(cost)
                event_handler(evt.EndIteration(pass_id, batch_id, cost, {}))
            event_handler(evt.EndPass(
                pass_id, metrics={"cost": float(np.mean(costs))
                                  if costs else 0.0}))

    def test(self, reader: Callable,
             feeding: Optional[Dict[str, int]] = None) -> "evt.TestResult":
        self.parameters.init()
        feeder = self._feeder(feeding)
        exe, scope = self.parameters.executor, self.parameters.scope
        prog = self.parameters.test_program_for(self.cost)
        costs = []
        for batch in reader():
            out = exe.run(prog, feed=feeder.feed(batch),
                          fetch_list=[self.cost], scope=scope)
            costs.append(float(np.asarray(out[0])))
        return evt.TestResult(float(np.mean(costs)) if costs else 0.0, {})
