"""Train an LM through the full production stack on the port: config
registry, data stream, AdamW + warmup-cosine, bf16 compute over f32
master weights, checkpoint/restart via TrainingRunner (kill it mid-run
and rerun: it resumes from the last atomic checkpoint and replays the
stream deterministically).

Default is the smoke config; --arch smollm-360m --full trains the real
360M config (on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 60]
      (add ``--device cpu`` to run on the CPU)
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (RunnerConfig,
                                                     TrainingRunner)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import count_params
from repro_torch.train import steps as S
from repro_torch.train.optimizer import AdamW, warmup_cosine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (not the smoke config)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.config if args.full else arch.smoke
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=2.0)
    print(f"training {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"moe={cfg.moe} on {dev}")

    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(cfg, gen, device=dev)
    print(f"parameters: {count_params(params)/1e6:.1f}M")

    opt = AdamW(lr=warmup_cosine(3e-3, 20, args.steps), weight_decay=0.01)
    opt_state = opt.init(params)
    step = S.make_lm_train_step(cfg, opt, remat=not args.full, q_chunk=32,
                                k_chunk=32, xent_chunk=32)

    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=0)
    runner = TrainingRunner(
        RunnerConfig(ckpt_dir=os.path.join(args.ckpt_dir, cfg.name),
                     ckpt_every=20, max_steps=args.steps),
        step, lambda i: {k: torch.from_numpy(v).to(dev)
                         for k, v in stream.batch_at(i).items()})
    params, opt_state, end = runner.run(params, opt_state)
    print(f"done at step {end}; events: {runner.events}")
    print("loss curve:", [round(x, 3) for x in runner.loss_history[::10]])
    # a rerun that resumes at the last step trains nothing
    losses = runner.loss_history
    assert not losses or losses[-1] < losses[0]
    return losses


if __name__ == "__main__":
    main()
