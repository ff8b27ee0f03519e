"""Serve a small LM with continuous batching on the port (on the card
unless ``--device cpu`` asks for the CPU): 12 requests of mixed prompt
lengths stream through a 4-slot pool; one decode step advances every
active sequence per iteration (on the card: one CUDA graph, and one
prefill graph a prompt length, with the flash kernel in prefill).

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.serve import Engine, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-360m").reduced(
        n_layers=4, d_model=256, vocab=2048)
    eng = Engine(cfg, slots=4, cache_len=256, seed=0, device=args.device)
    gen = torch.Generator().manual_seed(1)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(8 + 24 * float(torch.rand((), generator=gen)))
        prompt = torch.randint(0, cfg.vocab, (plen,), generator=gen).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    it = 0
    while eng.queue or eng.active:
        n_active = eng.step()
        it += 1
        if it % 10 == 0:
            print(f"iter {it}: active={n_active} queued={len(eng.queue)} "
                  f"done={len(eng.done)}", flush=True)
    wall = time.time() - t0

    toks = sum(len(r.out) for r in eng.done)
    result = {
        "requests": len(eng.done),
        "new_tokens": toks,
        "wall_s": round(wall, 2),
        "tok_per_s": round(toks / wall, 1),
        "mean_ttft_s": round(sum(r.t_first - r.t_arrival
                                 for r in eng.done) / len(eng.done), 3),
    }
    print(json.dumps(result))
    return {**result, "engine": eng}


if __name__ == "__main__":
    main()
