"""The ``train_lm_gspmd`` twin (dtdl_tpu_torch/examples/train_lm_gspmd.py)
as a user runs it, on the CPU: gloo worlds started by the port's
launcher, ``--rules tp --mesh 1,2`` over 2 processes and ``--rules ep
--n-experts 4 --mesh 2,2`` over 4, each against the twin in this process
at ``--rules replicated --mesh 1,1`` on the same seed and data (the same
global function).  Every logged loss and the validation metrics agree
within ``LOSS_TOL`` (the twin computes in bf16, as the JAX script's
model does, and a rank's partial products round to bf16 before their
f32 sum over 'model': rounding of a few bf16 ulps of the logits), and
the last line is the JAX script's ``final loss ... rules=... mesh=...``.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from _torch_world import REPO, free_port
from dtdl_tpu_torch.examples import train_lm_gspmd

SMALL = ["--platform", "cpu", "--seq-len", "32", "--batch-size", "4",
         "--steps", "4", "--log-interval", "1", "--eval-batches", "1"]
RUNS = {"tp": (2, ["--rules", "tp", "--mesh", "1,2"], []),
        "ep": (4, ["--rules", "ep", "--mesh", "2,2"],
               ["--n-experts", "4", "--moe-dispatch", "routed"])}
LOSS_TOL = 5e-3


@pytest.fixture(scope="module")
def runs():
    """Both worlds at once: {name: stdout}."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {}
    for name, (nproc, rules, extra) in RUNS.items():
        cmd = [sys.executable, "-m", "dtdl_tpu_torch.launch.local",
               "--nproc", str(nproc), "--port", str(free_port()),
               "--timeout", "240", "--", "-m",
               "dtdl_tpu_torch.examples.train_lm_gspmd", *SMALL, *rules,
               *extra]
        procs[name] = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text[-4000:]
        out[name] = text
    return out


def losses(text):
    return [float(m[1]) for m in re.finditer(r"\| loss: ([\d.]+)", text)]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_twin_matches_the_replicated_run(runs, name, capsys):
    nproc, rules, extra = RUNS[name]
    loss, val = train_lm_gspmd.main([*SMALL, "--rules", "replicated",
                                     "--mesh", "1,1", *extra])
    want = losses(capsys.readouterr().out)
    text = runs[name]
    lead = "\n".join(ln.split("] ", 1)[1] for ln in text.splitlines()
                     if ln.startswith("[rank 0]"))
    got = losses(lead)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=LOSS_TOL)
    last = [ln for ln in lead.splitlines() if ln.startswith("final loss")]
    shape = tuple(int(x) for x in rules[3].split(","))
    assert len(last) == 1 and last[0].endswith(
        f"rules={rules[1]} mesh={shape}")
    assert abs(float(last[0].split()[2]) - loss) <= LOSS_TOL
    # only the leader logs and prints the last line
    assert not any(ln.startswith("[rank 1]") and "loss" in ln
                   for ln in text.splitlines())
    assert np.isfinite(val["val_loss"])
