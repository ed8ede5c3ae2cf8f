"""Training launcher of the port: the reference's ``launch/train.py`` on
one NVIDIA card (or, with ``--device cpu``, on the CPU's plain versions).

    python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --steps 100 [--full] [--microbatches 4] [--ckpt DIR]

Seeded random weights (the reduced configuration unless ``--full``),
``--steps`` AdamW steps on the synthetic Markov task (``--batch`` rows of
``--seq`` tokens, so ``--seq - 1`` positions each), then held-out
perplexity on three fresh batches (the ragged dispatch's kernels: their
all-hi mode on the dense experts), and, with ``--ckpt``, the trained
parameters in the reference's checkpoint layout. It prints the
reference's ``[train]`` lines and the loop's step lines; ``main(argv)``
returns what it printed and measured, so a test or a harness can call it
in the same process. Language models only: the audio and VLM families
exit, as the reference's launcher does (their frontends are stubs).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import tree as T
from repro_torch.models.model import init_params
from repro_torch.training import (SyntheticLMTask, TrainConfig,
                                  save_checkpoint, train_loop)
from repro_torch.training.adamw import AdamWConfig
from repro_torch.training.train import eval_perplexity


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=65)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.family in ("audio", "vlm"):
        raise SystemExit(f"{args.arch}: LM-only trainer; frontends are "
                         f"stubbed (models/frontend.py)")
    dev = resolve_device(args.device)
    lines: List[str] = []

    def out(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    params = init_params(cfg, seed=0, device=dev)
    n = sum(t.numel() for t in T.leaves(params))
    out(f"[train] {cfg.name}: {n/1e6:.1f}M params on 1 device(s) ({dev})")
    task = SyntheticLMTask(cfg.vocab_size, seed=0)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps),
        microbatches=args.microbatches)
    steps: List[Dict] = []
    params, opt_state, hist = train_loop(
        cfg, params, task.batches(args.batch, args.seq, args.steps), tcfg,
        log_every=max(args.steps // 10, 1), log=out, steps=steps)
    ppl = eval_perplexity(cfg, params,
                          task.batches(args.batch, args.seq, 3, seed=9999))
    out(f"[train] final loss {hist[-1]['loss']:.3f}  held-out ppl {ppl:.2f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        out(f"[train] checkpoint → {args.ckpt}")
    return {"history": hist, "ppl": ppl, "lines": lines, "cfg": cfg,
            "params": params, "opt_state": opt_state, "steps": steps,
            "n_params": n, "task": task}


if __name__ == "__main__":
    main()
