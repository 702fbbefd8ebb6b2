"""Serving launcher: drive batched requests through ``ServingEngine``.

The counterpart of ``repro.launch.serve``, with the same flags (and the
same reduced config) plus ``--device``, which defaults to the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests 8 --max-new 16 [--device cpu]

``--arch`` takes any of the ten architectures (``configs.list_archs()``,
the JAX package's).  As in the JAX package, requests carry text only: a
served vlm (internvl2-2b) sees no patches, and a served encdec
(whisper-tiny) decoder cross-attends the zero ``xk``/``xv`` cache, which
nothing fills.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.models.model import init_params
from repro_torch.serve.serve_step import Request, ServingEngine


def throughput_report(cfg, n_requests: int, total_tokens: int,
                      wall: float) -> dict:
    return {
        "arch": cfg.name,
        "requests": n_requests,
        "tokens": total_tokens,
        "wall_s": round(wall, 3),
        "tok_per_s": round(total_tokens / max(wall, 1e-9), 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for prompt sampling and param init")
    ap.add_argument("--device", default="cuda",
                    help="torch device; raises without CUDA unless 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = init_params(cfg, args.seed, device=args.device)
    eng = ServingEngine(cfg, model, slots=args.slots, max_seq=args.max_seq,
                        device=args.device)
    rng = np.random.RandomState(args.seed)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, size=4 + i % 5),
                    args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)  # returns host arrays: the device work is done
    rep = throughput_report(cfg, len(done),
                            sum(len(r.out) for r in done),
                            time.perf_counter() - t0)
    print(rep)
    return rep


if __name__ == "__main__":
    main()
