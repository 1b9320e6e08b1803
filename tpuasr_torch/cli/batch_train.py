"""``python -m tpuasr_torch.cli.batch_train <model> --train-manifest m.jsonl``

Train an acoustic model with the port: the counterpart of
``tpuasr/cli/batch_train.py``, with its flags and defaults. The manifest
goes through ``AudioLoader`` (and the device-resident corpus where it
fits), ``Trainer.fit`` runs the epochs on ``--device`` (the card by
default; ``cpu`` where asked), logs to ``<log-dir>/tpuasr.log`` and
``<log-dir>/metrics.csv``, and writes checkpoints in JAX's msgpack format
to ``--checkpoint-dir`` (default ``<log-dir>/ckpt``), which
``--continue-from`` resumes (a file, or a directory's newest; a JAX
checkpoint too) and ``tpuasr_torch.cli.predict``/``test`` serve.
``--preset`` applies the model's preset (``utils/params.py``); explicit
flags still win.

Not ported, and exiting with a message: ``--objective`` other than
``ctc`` (ROADMAP Queue 1 item 12) and ``--use-grain`` (item 5: the Grain
package is not installed beside the card).
"""

from __future__ import annotations

import argparse
import ast

from tpuasr_torch.cli.common import add_model_flags, feature_config, load_units
from tpuasr_torch.data import AudioLoader, LoaderConfig
from tpuasr_torch.train import TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpuasr_torch.cli.batch_train")
    add_model_flags(p, serving=False)
    p.add_argument("--use-cuda", action="store_true",
                   help="accepted for the reference CLI's sake; --device "
                        "picks the device")
    p.add_argument("--train-manifest", required=True)
    p.add_argument("--dev-manifest", default=None)
    p.add_argument("--num-classes", type=int, default=None,
                   help="default: len(units file)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-epochs", type=int, default=10)
    p.add_argument("--max-label-len", type=int, default=64)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adam", "sgd"])
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--grad-clip", type=float, default=5.0)
    p.add_argument("--warmup-steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", default="runs/default")
    p.add_argument("--checkpoint-dir", default=None,
                   help="default: <log-dir>/ckpt")
    p.add_argument("--continue-from", default=None,
                   help="checkpoint file or dir to resume from (the port's "
                        "or JAX's)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-every-steps", type=int, default=500)
    p.add_argument("--objective", default="ctc",
                   choices=["ctc", "framewise_ce", "seq2seq_ce",
                            "ssvae_elbo"],
                   help="only ctc is ported")
    p.add_argument("--ctc-impl", default="fb",
                   choices=["ref", "fb", "pallas"],
                   help="CTC loss: ref (autograd through the recursion); fb "
                        "and pallas are one function in the port (K6/K6b "
                        "on the card)")
    p.add_argument("--fused-featurizer", action="store_true",
                   help="the fused featurizer kernel (K1)")
    p.add_argument("--pallas-gru", action="store_true",
                   help="the model's pallas_gru flag (deepspeech models)")
    p.add_argument("--model-kwarg", action="append", default=[],
                   metavar="K=V",
                   help="extra model constructor kwarg (repeatable); values "
                        "parsed as python literals when possible")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host prefetch queue depth (0 = the input pipeline "
                        "on the step's critical path)")
    p.add_argument("--use-grain", action="store_true",
                   help="not ported (the Grain package is not installed "
                        "beside the card)")
    p.add_argument("--grain-workers", type=int, default=0)
    p.add_argument("--lr-schedule", default="warmup",
                   choices=["warmup", "cosine"])
    p.add_argument("--decay-steps", type=int, default=10000,
                   help="cosine decay horizon (with --lr-schedule cosine)")
    p.add_argument("--spec-augment", action="store_true",
                   help="SpecAugment in the train step "
                        "(tpuasr_torch/features/augment.py)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: apply optimizer updates "
                        "every N micro-batches")
    p.add_argument("--preset", action="store_true",
                   help="apply the model's hyperparameter preset "
                        "(tpuasr_torch/utils/params.py); explicit flags "
                        "still win")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.objective != "ctc":
        raise SystemExit(f"--objective {args.objective} is not ported to "
                         "tpuasr_torch (ROADMAP Queue 1 item 12); train with "
                         "--objective ctc")
    if args.use_grain:
        raise SystemExit("--use-grain is not ported to tpuasr_torch (ROADMAP "
                         "Queue 1 item 5: the Grain package is not installed "
                         "beside the card)")
    units = load_units(args.units)
    num_classes = args.num_classes or (len(units) if units else None)
    if not num_classes:
        raise SystemExit("--num-classes or --units is required")
    ckpt_dir = args.checkpoint_dir or f"{args.log_dir}/ckpt"
    model_kwargs = {}
    train_overrides = {}
    if args.preset:
        from tpuasr_torch.utils.params import preset_for
        model_kwargs, train_overrides = preset_for(args.model)
    if args.pallas_gru and args.model in ("deepspeech_ctc", "deepspeech_var"):
        model_kwargs["pallas_gru"] = True
    for kv in args.model_kwarg:
        k, _, v = kv.partition("=")
        try:
            model_kwargs[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            model_kwargs[k] = v
    cfg = TrainConfig(
        model=args.model, num_classes=num_classes, optimizer=args.optimizer,
        lr=args.lr, grad_clip=args.grad_clip, warmup_steps=args.warmup_steps,
        num_epochs=args.num_epochs, seed=args.seed, log_every=args.log_every,
        ckpt_dir=ckpt_dir, ckpt_every_steps=args.ckpt_every_steps,
        continue_from=args.continue_from, objective=args.objective,
        ctc_impl=args.ctc_impl, fused_featurizer=args.fused_featurizer,
        prefetch=args.prefetch, use_grain=args.use_grain,
        grain_workers=args.grain_workers, spec_augment=args.spec_augment,
        accum_steps=args.accum_steps, lr_schedule=args.lr_schedule,
        decay_steps=args.decay_steps, model_kwargs=model_kwargs)
    # The preset fills the fields left at the parser's defaults.
    defaults = build_parser()
    for k, v in train_overrides.items():
        if getattr(args, k, None) == defaults.get_default(k):
            setattr(cfg, k, v)
    lcfg = LoaderConfig(batch_size=args.batch_size,
                        max_label_len=args.max_label_len, seed=args.seed)
    train_loader = AudioLoader(args.train_manifest, lcfg)
    dev_loader = (AudioLoader(args.dev_manifest,
                              LoaderConfig(batch_size=args.batch_size,
                                           max_label_len=args.max_label_len,
                                           shuffle=False))
                  if args.dev_manifest else None)
    from tpuasr_torch.utils.logger import init_logger
    logger = init_logger("tpuasr", args.log_dir)
    trainer = Trainer(cfg, feature_config(args), device=args.device,
                      logger=logger)
    state = trainer.fit(train_loader, dev_loader, metrics_dir=args.log_dir)
    logger.info("training done at step %d; checkpoints in %s", state.step,
                ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
