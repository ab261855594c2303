"""Fault tolerance, the port of dtdl_tpu/resil/: the seeded
:class:`FaultPlan` harness (:mod:`~dtdl_tpu_torch.resil.faults`) and
the SIGTERM :class:`PreemptionWatcher`
(:mod:`~dtdl_tpu_torch.resil.preempt`).  Checkpoint integrity (commit
markers, quarantine and fallback) lives in
dtdl_tpu_torch/ckpt/checkpoint.py.  The step guard (``guard.py``) and
elastic training (``elastic.py``) are ROADMAP queue A13.
"""

from dtdl_tpu_torch.resil.faults import (  # noqa: F401
    Fault, FaultPlan, InjectedCrash, InjectedFault, LoaderFaults, fire,
    peer_site, poison_batch, replica_site, store_site,
)
from dtdl_tpu_torch.resil.preempt import PreemptionWatcher  # noqa: F401
