"""Multi-tenant serving, the port of dtdl_tpu/serve/tenant/: batched
multi-LoRA adapters, grammar-constrained decoding and per-request token
streams, three legs on the same slots and steps as plain decode."""

from dtdl_tpu_torch.serve.tenant.grammar import (TokenDFA, byte_vocab,
                                                 compile_json_schema,
                                                 compile_regex,
                                                 json_schema_to_regex)
from dtdl_tpu_torch.serve.tenant.lora import (AdapterBank,
                                              AdapterBankFullError,
                                              adapter_template, bank_nbytes,
                                              bank_pspecs, init_bank,
                                              merge_adapter, place_bank)
from dtdl_tpu_torch.serve.tenant.stream import TokenStream

__all__ = [
    "TokenDFA", "byte_vocab", "compile_json_schema", "compile_regex",
    "json_schema_to_regex",
    "AdapterBank", "AdapterBankFullError", "adapter_template",
    "bank_nbytes", "bank_pspecs", "init_bank", "merge_adapter",
    "place_bank",
    "TokenStream",
]
