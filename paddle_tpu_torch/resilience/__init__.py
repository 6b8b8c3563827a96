"""paddle_tpu_torch.resilience: preemption-safe training.

Counterpart of ``paddle_tpu/resilience``: periodic and on-signal
checkpointing with auto-resume (:class:`CheckpointConfig` /
:class:`CheckpointManager`, driven by ``SGD.train(checkpoint=...)``),
graceful SIGTERM/SIGINT shutdown (:func:`graceful_shutdown`), a bounded
retry policy (:class:`Retry`) and a deterministic fault-injection plan
(:class:`FaultPlan`) for crash-and-resume checks and ``--fault_plan``
drills.

Quick start::

    from paddle_tpu_torch.resilience import CheckpointConfig
    trainer.train(reader, num_passes=10,
                  checkpoint=CheckpointConfig("/ckpt/run1",
                                              every_n_steps=200))

Interrupt it (SIGTERM, preemption, crash) and run the same script again:
it resumes from the latest intact checkpoint (parameters, optimizer
slots, RNG key and data position) to the bit-identical end state.
"""
from .faults import (FAULT_KINDS, FaultPlan, SimulatedCrash, TransientFault,
                     active_plan, clear_plan, install_plan)
from .manager import (CheckpointConfig, CheckpointManager, TrainResilience)
from .retry import DEFAULT_RETRYABLE, Retry
from .signals import ShutdownFlag, graceful_shutdown

__all__ = [
    "FAULT_KINDS", "FaultPlan", "SimulatedCrash", "TransientFault",
    "active_plan", "clear_plan", "install_plan",
    "CheckpointConfig", "CheckpointManager", "TrainResilience",
    "DEFAULT_RETRYABLE", "Retry",
    "ShutdownFlag", "graceful_shutdown",
]
