"""JAX's trace-hygiene rules as catalog entries, the counterpart of
dtdl_tpu/analysis/rules/trace_hygiene.py.

JAX's rules flag a wall clock or a host random draw inside a function
that gets traced: it runs once, at trace time, and its value is baked
into the program.  The port runs eagerly, so a clock or a draw runs
every step and means what it says; nothing is traced and no AST check is
registered.  The hazard returns with CUDA-graph capture (ROADMAP's speed
note on capture): a host value read inside a captured region is frozen
into the graph, and the rule then comes back over the captured
functions.
"""

RULES = {
    "trace-host-time": "JAX rule (a host clock inside a traced "
                       "function); in the port: none until CUDA-graph "
                       "capture (nothing is traced)",
    "trace-host-rng": "JAX rule (a host RNG draw inside a traced "
                      "function); in the port: none until CUDA-graph "
                      "capture (nothing is traced)",
}
