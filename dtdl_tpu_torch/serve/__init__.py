"""The port's serving stack: engine, scheduler, sampling and drafts, the
page allocator and its spill tiers, and the fleet (Router, replicas,
health, the prefix directory)."""

from dtdl_tpu_torch.serve.draft import DraftSource, ModelDraft, NGramDraft
from dtdl_tpu_torch.serve.engine import InferenceEngine, PromptTooLongError
from dtdl_tpu_torch.serve.fleet import (FleetMetrics, PrefixDirectory,
                                        Replica, Router)
from dtdl_tpu_torch.serve.health import (DRAINING, EVICTED, HEALTHY,
                                         SUSPECT, ReplicaHealth)
from dtdl_tpu_torch.serve.metrics import (ERROR_KINDS, UNAVAILABLE_KINDS,
                                          ServeMetrics, error_kind)
from dtdl_tpu_torch.serve.paged import (GARBAGE_PAGE, DiskPageStore,
                                        HostPageStore, PageAllocator,
                                        PagePoolExhaustedError,
                                        SpillCorruptEntryError,
                                        page_chain_hashes)
from dtdl_tpu_torch.serve.sampling import (GREEDY, SampleParams,
                                           accept_resample, filter_logits,
                                           sample)
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["DRAINING", "DiskPageStore", "DraftSource", "ERROR_KINDS",
           "EVICTED", "FleetMetrics", "GARBAGE_PAGE", "GREEDY", "HEALTHY",
           "HostPageStore", "InferenceEngine", "ModelDraft", "NGramDraft",
           "PageAllocator", "PagePoolExhaustedError", "PrefixDirectory",
           "PromptTooLongError", "Replica", "ReplicaHealth", "Request",
           "Router", "SUSPECT", "SampleParams", "Scheduler", "ServeMetrics",
           "SpillCorruptEntryError", "UNAVAILABLE_KINDS", "accept_resample",
           "error_kind", "filter_logits", "page_chain_hashes", "sample"]
