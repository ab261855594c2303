"""Chunked prefill and speculative decoding of a routed MoE LM: the
port's scheduler against the JAX package's (the setup, config and
traffic of tests/test_torch_moe_serve.py).

At capacity factor 1.25 a chunk window or a verify window routes other
groups than whole-prompt prefill or a decode step, so the port is held
to the JAX scheduler run for run; at capacity factor 4 (= E / top_k)
nothing drops and chunked and speculative serving give plain serving's
tokens.

Tolerance: greedy tokens and the scheduler's counters exactly equal.
"""

import pytest

from test_torch_moe_serve import (PAGED, _engines, _serve, _traffic,
                                  check_tokens_match_jax)


@pytest.mark.parametrize("case", ["chunked", "spec", "chunked_spec"])
def test_moe_chunked_and_spec_tokens_match_jax(case):
    """Chunked prefill (chunk_tokens=5), speculate=4 with n-gram drafts,
    and both, on the paged engine at capacity factor 1.25."""
    check_tokens_match_jax(case)


def test_without_drops_chunked_and_spec_equal_plain():
    """At capacity factor 4 no token can drop, so routing no longer
    depends on the window: chunked, speculative and both give the tokens
    of plain whole-prompt serving, and the JAX scheduler's."""
    jeng, teng = _engines(capacity_factor=4.0, **PAGED)
    traffic = _traffic(2)
    plain, _ = _serve(teng, traffic)
    for run in (dict(chunk=5), dict(spec=4), dict(chunk=5, spec=4)):
        got, _ = _serve(teng, traffic, **run)
        assert got == plain, run
    want, _ = _serve(jeng, traffic, jax_side=True, chunk=5, spec=4)
    assert want == plain
