#!/usr/bin/env python
"""4D-parallel LM training, dp × sp × pp × tp (+ expert parallel), the
twin of examples/train_lm_4d.py: one process per rank of a
``(data, seq, pipe, model)`` mesh (:mod:`dtdl_tpu_torch.parallel.megatron`),
ring attention over 'seq', 1F1B or GPipe over 'pipe', Megatron tensor
parallelism and expert-parallel MoE over 'model'.

    python -m dtdl_tpu_torch.examples.train_lm_4d --steps 20 --mesh 1,1,1,1
    python -m dtdl_tpu_torch.launch.local --nproc 8 -- \\
        -m dtdl_tpu_torch.examples.train_lm_4d --mesh 1,2,2,2 --platform cpu

The mesh is factored from the world size (:func:`factor_mesh`) unless
``--mesh data,seq,pipe,model`` gives it.  Each rank snapshots its own
shards under ``--out``/``process_<rank>`` and resumes from them
(``--resume``).  ``--generate-tokens`` decodes through the serving
bridge (``to_flax_params`` into the port's ``TransformerLM``) in a
single-process run.  ``--platform cpu`` runs on the CPU (gloo).
"""

import os

import numpy as np
import torch

from dtdl_tpu_torch.bridge import load_flax_params
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.data.datasets import load_dataset
from dtdl_tpu_torch.examples.common import bootstrap
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models.transformer import generate
from dtdl_tpu_torch.parallel import megatron as M
from dtdl_tpu_torch.runtime import build_mesh, process_count, process_index
from dtdl_tpu_torch.train.optim import adamw
from dtdl_tpu_torch.utils.config import (add_data_flags, add_topology_flags,
                                         add_train_flags, flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything

VOCAB = 256


def parse(argv=None):
    parser = make_parser("dtdl_tpu_torch: 4D-parallel (dp/sp/pp/tp+ep) LM "
                         "training")
    add_train_flags(parser, batch_size=8, lr=1e-3, epochs=1)
    add_data_flags(parser, dataset="synthetic_lm")
    add_topology_flags(parser)
    flag(parser, "--steps", type=int, default=20, help="train steps to run")
    flag(parser, "--seq-len", type=int, default=128)
    flag(parser, "--d-model", type=int, default=128)
    flag(parser, "--n-heads", type=int, default=8)
    flag(parser, "--d-ff", type=int, default=256)
    flag(parser, "--layers-per-stage", type=int, default=1)
    flag(parser, "--n-experts", type=int, default=0,
         help="0 = dense MLP; >0 enables expert-parallel MoE")
    flag(parser, "--moe-dispatch", default="routed",
         choices=["routed", "dense"],
         help="MoE dispatch: capacity-factor top-k + all-to-all (routed) "
              "or the dense one-hot oracle")
    flag(parser, "--capacity-factor", type=float, default=1.25,
         help="per-expert token slots = cf * tokens * k / n_experts (routed)")
    flag(parser, "--moe-top-k", type=int, default=1,
         help="experts per token: 1 = Switch routing, 2 = GShard-style "
              "renormalized top-2")
    flag(parser, "--moe-aux-weight", type=float, default=0.01,
         help="Switch load-balance aux loss weight (added to the training "
              "loss; 0 disables)")
    flag(parser, "--microbatches", type=int, default=2)
    flag(parser, "--schedule", default="1f1b", choices=["1f1b", "gpipe"],
         help="pipeline schedule")
    flag(parser, "--virtual-stages", type=int, default=1,
         help=">1 = interleaved 1F1B: v layer chunks per device (requires "
              "--schedule 1f1b and layers-per-stage divisible by v)")
    flag(parser, "--mesh", default="",
         help="data,seq,pipe,model sizes, e.g. 1,2,2,2 (default: auto)")
    flag(parser, "--out", "-o", default="",
         help="checkpoint directory (empty = no checkpointing)")
    flag(parser, "--resume", "-r", action="store_true",
         help="resume from the latest snapshot in --out")
    flag(parser, "--ckpt-interval", type=int, default=0,
         help="snapshot every N steps (0 = only at the end)")
    flag(parser, "--eval-interval", type=int, default=0,
         help="run held-out validation every N steps (0 = only at the end)")
    flag(parser, "--eval-batches", type=int, default=2,
         help="validation batches per evaluation")
    flag(parser, "--generate-tokens", type=int, default=0,
         help=">0: after training, convert the 4D params to the flax tree "
              "(megatron.to_flax_params), load it into the port's "
              "TransformerLM and greedily decode this many tokens "
              "(single-process runs only)")
    args = parser.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    if args.dataset != "synthetic_lm":
        raise SystemExit("train_lm_4d trains on token data; "
                         "use --dataset synthetic_lm")
    return args


def main(argv=None):
    """Train; returns ``(last loss, last validation metrics)``."""
    args = parse(argv)
    device = bootstrap(args)
    seed_everything(args.seed)

    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if len(shape) != 4:
            raise SystemExit("--mesh needs 4 sizes: data,seq,pipe,model")
        mesh = build_mesh(shape, M.AXES)
    else:
        mesh = M.build_4d_mesh()
    shape = dict(mesh.shape)

    cfg = M.MegatronConfig(
        vocab_size=VOCAB, d_model=args.d_model, n_heads=args.n_heads,
        d_ff=args.d_ff, n_stages=shape["pipe"],
        layers_per_stage=args.layers_per_stage,
        n_experts=args.n_experts, max_seq=args.seq_len,
        n_microbatches=args.microbatches, schedule=args.schedule,
        virtual_stages=args.virtual_stages,
        moe_dispatch=args.moe_dispatch,
        capacity_factor=args.capacity_factor,
        moe_top_k=args.moe_top_k,
        moe_aux_weight=args.moe_aux_weight)
    if args.n_experts and args.n_experts % shape["model"]:
        raise SystemExit(f"--n-experts must be divisible by "
                         f"tp={shape['model']}")

    # seq_len+1 tokens per sequence, so that the shifted inputs and
    # targets both span seq_len positions
    train_tokens, test_tokens = load_dataset(
        args.dataset, seq_len=args.seq_len + 1, vocab_size=VOCAB)
    if args.batch_size % shape["data"] or \
            (args.batch_size // shape["data"]) % args.microbatches:
        raise SystemExit("--batch-size must be divisible by data-axis size "
                         "times --microbatches")
    if shape["seq"] > 1 and args.seq_len % (2 * shape["seq"]):
        raise SystemExit("--seq-len must be divisible by 2x the seq-axis "
                         "size (zigzag ring layout)")
    params = M.place_params(mesh, cfg, M.init_params(cfg, args.seed),
                            device=device)
    opt = adamw(args.lr)
    opt_state = M.init_optimizer(cfg, mesh, opt, params)
    step = M.make_megatron_train_step(cfg, mesh, opt)

    # each rank snapshots its own shards (and optimizer state) beside the
    # step counter, so an interrupted run continues exactly
    ckpt, start_step = None, 0
    if args.out:
        ckpt = Checkpointer(os.path.join(args.out,
                                         f"process_{process_index()}"),
                            keep=3, per_process=True)
        if args.resume:
            like = {"params": params, "step": 0,
                    "opt_state": M.opt_state_tree(params, opt_state,
                                                  install=True)}
            snap, at = ckpt.restore(like)
            if snap is not None:
                with torch.no_grad():
                    for (_, dst), (_, src) in zip(M._leaves(params),
                                                  M._leaves(snap["params"])):
                        dst.copy_(src)
                M.load_opt_state(params, opt_state, snap["opt_state"])
                start_step = int(snap["step"])
                print(f"resumed from snapshot at step {start_step}",
                      flush=True)
    if start_step >= args.steps:
        print(f"already complete: snapshot at step {start_step} >= "
              f"--steps {args.steps}; nothing to do", flush=True)
        ckpt.close()
        return None, None

    reporter = Reporter([StdoutSink()])
    B, S = args.batch_size, args.seq_len
    n_seqs = len(train_tokens)
    loss = float("nan")
    eval_step = M.make_megatron_eval_step(cfg, mesh)

    def lm_batch(toks):
        return M.shard_lm_batch(mesh, {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, S), np.float32)}, device=device)

    def run_eval(step_no):
        loss_sum = correct_sum = tok_sum = 0.0
        for j in range(args.eval_batches):
            take = np.arange(j * B, (j + 1) * B) % len(test_tokens)
            vb = lm_batch(test_tokens[take])
            m = eval_step(params, vb["tokens"], vb["targets"], vb["mask"])
            n = float(m["n_tokens"])
            loss_sum += float(m["loss"]) * n
            correct_sum += float(m["accuracy"]) * n
            tok_sum += n
        row = {"step": step_no, "val_loss": loss_sum / max(tok_sum, 1.0),
               "val_accuracy": correct_sum / max(tok_sum, 1.0),
               "val_tokens": tok_sum}
        reporter.report(row)
        return row

    try:
        for i in range(start_step, args.steps):
            take = np.arange(i * B, (i + 1) * B) % n_seqs
            batch = lm_batch(train_tokens[take])
            params, opt_state, loss, metrics = step(
                params, opt_state, batch["tokens"], batch["targets"],
                batch["mask"])
            done = i + 1
            if i % args.log_interval == 0:
                reporter.report({"step": i, "loss": float(loss),
                                 "mesh": str(shape),
                                 **{k: float(v) for k, v in metrics.items()}})
            if args.eval_interval and done % args.eval_interval == 0:
                run_eval(done)
            if ckpt and ((args.ckpt_interval and done % args.ckpt_interval
                          == 0) or done == args.steps):
                ckpt.save(done, {"params": params, "step": done,
                                 "opt_state": M.opt_state_tree(params,
                                                               opt_state)})
    finally:
        if ckpt:
            ckpt.wait_until_finished()
            ckpt.close()
    val = None
    if not args.eval_interval or args.steps % args.eval_interval:
        val = run_eval(args.steps)   # end-of-run validation (always)

    if args.generate_tokens:
        if process_count() > 1:
            print("skipping --generate-tokens: multi-process params are "
                  "shards of the model", flush=True)
        else:
            # the serving bridge: 4D stacked params -> flax tree -> the
            # port's TransformerLM (the trained routing; the rope table
            # extended to fit the decode)
            lm = M.to_flax_model(
                cfg, device=device,
                max_seq=max(args.seq_len, 8 + args.generate_tokens))
            load_flax_params(lm, M.to_flax_params(cfg, params),
                             device=device)
            toks_out = generate(lm, train_tokens[:1, :8],
                                args.generate_tokens)
            print("generated:", toks_out.cpu().numpy()[0].tolist(),
                  flush=True)

    print(f"final loss {float(loss):.6f} at step {args.steps} "
          f"on mesh {shape}", flush=True)
    return float(loss), val


if __name__ == "__main__":
    main()
