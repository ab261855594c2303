#!/usr/bin/env python
"""GSPMD-sharded LM training, tp / fsdp / tp_fsdp / ep by logical rules,
the twin of examples/train_lm_gspmd.py.

Every ``TransformerLM`` leaf carries its flax logical axes, and a rule
preset (:mod:`dtdl_tpu_torch.parallel.tensor` ``RULE_PRESETS``) maps them
onto a ``(data, model)`` mesh of processes, one a rank: ``--rules tp`` is
Megatron tensor parallelism, ``fsdp`` ZeRO-3, ``tp_fsdp`` both, ``ep``
shards the experts of a routed MoE (``--n-experts``) over 'model' with a
token all-to-all, ``replicated`` is data parallelism.

    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.train_lm_gspmd --rules tp --mesh 1,2
    python -m dtdl_tpu_torch.launch.local --nproc 4 -- \\
        -m dtdl_tpu_torch.examples.train_lm_gspmd --rules ep \\
        --n-experts 4 --platform cpu --mesh 2,2

As the JAX script, the model runs dense attention (``attn_impl='dense'``)
and no kernel.  ``--platform cpu`` runs on the CPU (gloo).  The last line
is the JAX script's: ``final loss ... rules=... mesh=(d, m)``.
"""

import numpy as np

from dtdl_tpu_torch.data.datasets import load_dataset
from dtdl_tpu_torch.examples.common import bootstrap
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.parallel.tensor import (RULE_PRESETS, init_sharded_lm,
                                            make_sharded_lm_eval_step,
                                            make_sharded_lm_train_step)
from dtdl_tpu_torch.runtime import build_mesh, is_leader, process_count
from dtdl_tpu_torch.runtime.mesh import batch_sharded
from dtdl_tpu_torch.train.optim import adamw
from dtdl_tpu_torch.utils.config import (add_data_flags, add_topology_flags,
                                         add_train_flags, flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything

VOCAB = 256


def parse(argv=None):
    parser = make_parser("dtdl_tpu_torch: GSPMD-sharded LM training "
                         "(tp / fsdp / ep logical rules)")
    add_train_flags(parser, batch_size=8, lr=1e-3, epochs=1)
    add_data_flags(parser, dataset="synthetic_lm")
    add_topology_flags(parser)
    flag(parser, "--rules", default="tp", choices=sorted(RULE_PRESETS),
         help="logical-axis rule preset (parallel/tensor.py)")
    flag(parser, "--steps", type=int, default=20)
    flag(parser, "--seq-len", type=int, default=128)
    flag(parser, "--model-size", default="tiny",
         choices=["tiny", "small", "base"])
    flag(parser, "--n-experts", type=int, default=0,
         help=">0: MoE MLPs (use --rules ep for expert parallelism)")
    flag(parser, "--moe-dispatch", default="routed",
         choices=["routed", "dense"])
    flag(parser, "--capacity-factor", type=float, default=1.25)
    flag(parser, "--moe-top-k", type=int, default=1)
    flag(parser, "--mesh", default="",
         help="data,model sizes, e.g. 2,4 (default: every process on "
              "'data' for fsdp/replicated, split 2-ways onto 'model' "
              "otherwise)")
    flag(parser, "--eval-batches", type=int, default=2,
         help="held-out validation batches after training")
    flag(parser, "--dist-backend", default="", choices=["", "nccl", "gloo"],
         help="collective backend; empty follows the device (gloo runs "
              "several ranks on one card)")
    args = parser.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    if args.dataset != "synthetic_lm":
        raise SystemExit("train_lm_gspmd trains on token data; "
                         "use --dataset synthetic_lm")
    return args


def main(argv=None):
    """Train and evaluate; returns ``(last loss, validation metrics)``."""
    args = parse(argv)
    device = bootstrap(args)
    seed_everything(args.seed)

    n = process_count()
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if len(shape) != 2:
            raise SystemExit("--mesh needs 2 sizes: data,model")
    elif args.rules in ("fsdp", "replicated"):
        shape = (n, 1)
    else:
        shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    mesh = build_mesh(shape, ("data", "model"))
    if args.batch_size % shape[0]:
        raise SystemExit(f"--batch-size must be divisible by the data "
                         f"axis size {shape[0]}")

    # the whole weights from the seed on the host; each rank keeps its
    # blocks on its device
    model = transformer_lm(
        args.model_size, max_seq=args.seq_len, attn_impl="dense",
        vocab_size=VOCAB, n_experts=args.n_experts, moe_every=1,
        moe_dispatch=args.moe_dispatch,
        capacity_factor=args.capacity_factor, moe_top_k=args.moe_top_k,
        device="cpu", seed=args.seed)
    train_tokens, test_tokens = load_dataset(
        args.dataset, seq_len=args.seq_len + 1, vocab_size=VOCAB)
    tx = adamw(args.lr)
    params, opt_state, sh = init_sharded_lm(model, mesh, tx,
                                            rules=args.rules, device=device)
    step = make_sharded_lm_train_step(model, mesh, tx, sh, rules=args.rules)

    reporter = Reporter([StdoutSink()])
    B = args.batch_size

    def rows(tokens, i):
        take = np.arange(i * B, (i + 1) * B) % len(tokens)
        return batch_sharded(mesh, np.ascontiguousarray(tokens[take],
                                                        np.int32),
                             device=device)

    loss = float("nan")
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state,
                                       rows(train_tokens, i))
        if i % args.log_interval == 0:
            reporter.report({"step": i, "loss": float(loss),
                             "rules": args.rules, "mesh": str(shape)})

    # held-out validation under the same placement, token-weighted over
    # --eval-batches batches
    ev = make_sharded_lm_eval_step(model, mesh, sh, rules=args.rules)
    loss_sum = acc_sum = tok_sum = 0.0
    for j in range(args.eval_batches):
        m = ev(params, rows(test_tokens, j))
        k = float(m["n_tokens"])
        loss_sum += float(m["loss"]) * k
        acc_sum += float(m["accuracy"]) * k
        tok_sum += k
    val = {"val_loss": loss_sum / max(tok_sum, 1.0),
           "val_accuracy": acc_sum / max(tok_sum, 1.0), "val_tokens": tok_sum}
    reporter.report({"step": args.steps, **val})
    if is_leader():
        print(f"final loss {float(loss):.6f} rules={args.rules} "
              f"mesh={shape}", flush=True)
    return float(loss), val


if __name__ == "__main__":
    main()
