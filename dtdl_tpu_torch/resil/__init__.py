"""Fault tolerance, the port of dtdl_tpu/resil/:

* :mod:`~dtdl_tpu_torch.resil.faults`: the seeded :class:`FaultPlan`
  harness that injects failures (loader exceptions, NaN bursts, torn
  checkpoint writes, SIGTERM, stalls, store and peer faults) at chosen
  occurrences;
* :mod:`~dtdl_tpu_torch.resil.guard`: :class:`StepGuard`, the finite
  check folded into the train step with the skip / rollback / raise
  policies, no wait for the card added;
* :mod:`~dtdl_tpu_torch.resil.preempt`: :class:`PreemptionWatcher`,
  SIGTERM, then a durable snapshot, then an exact mid-epoch resume;
* :mod:`~dtdl_tpu_torch.resil.elastic`: elastic training: heartbeat
  leases, deadline-guarded exchanges (:class:`PeerLostError`, never a
  silent hang), generation-fenced re-rendezvous, and shrink-to-survivors
  resume from the last committed snapshot, over the control-plane store
  (:mod:`dtdl_tpu_torch.parallel.kvstore`,
  :mod:`dtdl_tpu_torch.parallel.tcpstore`).

Checkpoint integrity (commit markers, quarantine and fallback) lives in
dtdl_tpu_torch/ckpt/checkpoint.py.
"""

from dtdl_tpu_torch.resil.elastic import (  # noqa: F401
    ElasticConfig, ElasticWorker, HeartbeatLease, PeerLostError,
    RendezvousError, StaleGenerationError, StepWatchdog, World,
    dead_peers, effective_sample_log, exchange_grads, rendezvous,
    run_workers,
)
from dtdl_tpu_torch.resil.faults import (  # noqa: F401
    Fault, FaultPlan, InjectedCrash, InjectedFault, LoaderFaults, fire,
    peer_site, poison_batch, replica_site, store_site,
)
from dtdl_tpu_torch.resil.guard import (  # noqa: F401
    AnomalousStepError, GuardEscalationError, GuardRollback, StepGuard,
)
from dtdl_tpu_torch.resil.preempt import PreemptionWatcher  # noqa: F401
