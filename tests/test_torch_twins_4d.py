"""The ``train_lm_4d`` twin (dtdl_tpu_torch/examples/train_lm_4d.py) as a
user runs it, on the CPU.

* A gloo world of 4 processes at ``--mesh 1,1,2,2`` (pipe and model
  over two each) with a routed MoE, started by the port's launcher: 4
  steps uninterrupted, against 2 steps and then ``--resume`` to 4 from
  the per-rank snapshots.  Every rank's final snapshot (parameters,
  adamw moments and step) is bitwise equal between the two runs, as are
  the logged losses; the eval lines come every ``--eval-interval``
  steps; ``--generate-tokens`` is skipped by name in a multi-process
  run, as the JAX script skips it.
* One process at ``--mesh 1,1,1,1`` with ``--generate-tokens``: the
  decoded tokens equal the JAX package's ``generate`` on its
  ``to_flax_model`` with the same trained weights converted by its
  ``to_flax_params`` (greedy, f32; tokens exact).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_world import REPO, free_port
from dtdl_tpu_torch.examples import train_lm_4d

SMALL = ["--platform", "cpu", "--d-model", "32", "--n-heads", "4",
         "--d-ff", "64", "--seq-len", "32", "--batch-size", "4",
         "--log-interval", "1"]
MOE = ["--n-experts", "4", "--moe-dispatch", "routed"]


def launch(args, nproc=4, timeout=240):
    cmd = [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
           str(nproc), "--port", str(free_port()), "--timeout",
           str(timeout), "--", "-m", "dtdl_tpu_torch.examples.train_lm_4d",
           *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout + 30)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout


def rank0(stdout, key):
    return [ln.split("] ", 1)[1] for ln in stdout.splitlines()
            if ln.startswith("[rank 0]") and key in ln]


def snapshot(out_dir, rank, step):
    return torch.load(os.path.join(out_dir, f"process_{rank}",
                                   f"snapshot_{step}", "state.pt"),
                      weights_only=True)


def flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("twin4d")
    mesh = ["--mesh", "1,1,2,2"]
    a = launch(SMALL + MOE + mesh + ["--steps", "4", "--out",
                                     str(root / "a"), "--eval-interval", "2",
                                     "--generate-tokens", "4"])
    b1 = launch(SMALL + MOE + mesh + ["--steps", "2", "--out",
                                      str(root / "b"), "--eval-interval",
                                      "2"])
    b2 = launch(SMALL + MOE + mesh + ["--steps", "4", "--out",
                                      str(root / "b"), "--eval-interval", "2",
                                      "--resume"])
    return root, a, b1, b2


def test_twin_resume_is_bitwise_in_a_gloo_world(runs):
    root, a, b1, b2 = runs
    assert rank0(b2, "resumed from snapshot at step 2")
    steps_a = rank0(a, "| loss:")
    assert len(steps_a) == 4 and "moe_dropped_frac" in steps_a[0]
    assert rank0(b1, "| loss:") + rank0(b2, "| loss:") == steps_a
    assert rank0(a, "final loss") == rank0(b2, "final loss")
    for rank in range(4):
        want = dict(flat(snapshot(root / "a", rank, 4)))
        got = dict(flat(snapshot(root / "b", rank, 4)))
        assert got.keys() == want.keys() and want["step"] == 4
        for path, x in want.items():
            if isinstance(x, torch.Tensor):
                assert torch.equal(got[path], x), (rank, path)


def test_twin_evaluates_and_skips_multiprocess_generate(runs):
    _, a, _, b2 = runs
    evals = rank0(a, "val_loss")
    assert [e.split(" |")[0] for e in evals] == ["step 2", "step 4"]
    assert rank0(a, "skipping --generate-tokens")
    assert rank0(b2, "val_loss")[-1] == evals[-1]
    # the leader reports; the other ranks print no metric lines
    assert not [ln for ln in a.splitlines()
                if ln.startswith("[rank 1]") and "| loss:" in ln]


def test_twin_generate_matches_jax_bridge(tmp_path, capsys):
    """One process: the twin's decode through the port's bridge equals
    the JAX bridge's decode of the same trained weights."""
    import jax
    import jax.numpy as jnp

    from dtdl_tpu.models import generate as jax_generate
    from dtdl_tpu.parallel import megatron as JM

    n_new = 6
    loss, val = train_lm_4d.main(SMALL + ["--mesh", "1,1,1,1", "--steps",
                                          "3", "--out", str(tmp_path),
                                          "--generate-tokens", str(n_new)])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and val["val_tokens"] == 4 * 32 * 2
    got = [ln for ln in out.splitlines() if ln.startswith("generated:")]
    assert len(got) == 1
    tokens = eval(got[0].split(":", 1)[1])
    params = snapshot(tmp_path, 0, 3)["params"]
    params = jax.tree.map(lambda t: np.asarray(t.numpy()), params)
    jc = JM.MegatronConfig(vocab_size=256, d_model=32, n_heads=4, d_ff=64,
                           n_stages=1, max_seq=32)
    lm = JM.to_flax_model(jc, max_seq=max(32, 8 + n_new))
    prompt = train_lm_4d.load_dataset("synthetic_lm", seq_len=33,
                                      vocab_size=256)[0][:1, :8]
    want = jax_generate(lm, JM.to_flax_params(jc, params),
                        jnp.asarray(prompt, jnp.int32),
                        max_new_tokens=n_new)
    assert tokens == np.asarray(want)[0].tolist()
    assert len(tokens) == 8 + n_new
