"""JAX's donation rule as a catalog entry, the counterpart of
dtdl_tpu/analysis/rules/donation.py.

JAX's ``jit-donate`` flags a state-threading ``jax.jit`` without
``donate_argnums``: XLA would then allocate a fresh copy of the train
state or the KV arena every call.  Eager PyTorch has no jit targets to
lint; a step updates its state in place or it does not, and only running
it can tell.  The counterpart is therefore the program audit's
``storage_kept`` field (dtdl_tpu_torch/analysis/program_audit.py): the
storages of a train step's parameters and optimizer moments, or of an
engine's KV pools, are the same before and after the call, else the
finding ``program-storage-moved``.  No AST check is registered.
"""

RULES = {
    "jit-donate": "JAX rule (a state-threading jax.jit without "
                  "donate_argnums); in the port: the program audit's "
                  "storage check, program-storage-moved",
}
