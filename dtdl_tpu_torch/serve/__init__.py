"""The port's serving stack: engine, scheduler, sampling and drafts."""

from dtdl_tpu_torch.serve.draft import DraftSource, ModelDraft, NGramDraft
from dtdl_tpu_torch.serve.engine import InferenceEngine, PromptTooLongError
from dtdl_tpu_torch.serve.sampling import (GREEDY, SampleParams,
                                           accept_resample, filter_logits,
                                           sample)
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["DraftSource", "GREEDY", "InferenceEngine", "ModelDraft",
           "NGramDraft", "PromptTooLongError", "Request", "SampleParams",
           "Scheduler", "accept_resample", "filter_logits", "sample"]
