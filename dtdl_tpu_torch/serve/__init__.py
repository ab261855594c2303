"""The port's serving stack: engine, scheduler, sampling and drafts, the
page allocator and its spill tiers, the fleet (Router, replicas, health,
the prefix directory), and tenancy (batched multi-LoRA, grammar DFAs,
token streams; :mod:`dtdl_tpu_torch.serve.tenant`), with the standard
serving SLOs (``default_fleet_slos``)."""

from dtdl_tpu_torch.serve.draft import DraftSource, ModelDraft, NGramDraft
from dtdl_tpu_torch.serve.engine import (InferenceEngine, PromptTooLongError,
                                         default_buckets)
from dtdl_tpu_torch.serve.fleet import (FleetMetrics, PrefixDirectory,
                                        Replica, Router, default_fleet_slos)
from dtdl_tpu_torch.serve.health import (DRAINING, EVICTED, HEALTHY,
                                         SUSPECT, ReplicaHealth)
from dtdl_tpu_torch.serve.metrics import (ERROR_KINDS, UNAVAILABLE_KINDS,
                                          ServeMetrics, error_kind)
from dtdl_tpu_torch.serve.paged import (GARBAGE_PAGE, DiskPageStore,
                                        HostPageStore, PageAllocator,
                                        PagePoolExhaustedError,
                                        SpillCorruptEntryError,
                                        adapter_salt, page_chain_hashes)
from dtdl_tpu_torch.serve.sampling import (GREEDY, SampleParams,
                                           accept_resample, filter_logits,
                                           filter_logits_sorted, mask_words,
                                           pack_mask, sample, unpack_mask)
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
from dtdl_tpu_torch.serve.tenant import (AdapterBank, AdapterBankFullError,
                                         TokenDFA, TokenStream,
                                         adapter_template, byte_vocab,
                                         compile_json_schema, compile_regex,
                                         json_schema_to_regex, merge_adapter)

__all__ = ["AdapterBank", "AdapterBankFullError", "DRAINING",
           "DiskPageStore", "DraftSource", "ERROR_KINDS", "EVICTED",
           "FleetMetrics", "GARBAGE_PAGE", "GREEDY", "HEALTHY",
           "HostPageStore", "InferenceEngine", "ModelDraft", "NGramDraft",
           "PageAllocator", "PagePoolExhaustedError", "PrefixDirectory",
           "PromptTooLongError", "Replica", "ReplicaHealth", "Request",
           "Router", "SUSPECT", "SampleParams", "Scheduler", "ServeMetrics",
           "SpillCorruptEntryError", "TokenDFA", "TokenStream",
           "UNAVAILABLE_KINDS", "accept_resample", "adapter_salt",
           "adapter_template", "byte_vocab", "compile_json_schema",
           "compile_regex", "default_buckets", "default_fleet_slos",
           "error_kind", "filter_logits", "filter_logits_sorted",
           "json_schema_to_regex", "mask_words", "merge_adapter",
           "pack_mask", "page_chain_hashes", "sample", "unpack_mask"]
