"""Serving example on the PyTorch/CUDA port: the continuous-batching engine
against the static-batch path.

Requests stream through ``repro_torch.serve.Engine``: FIFO admission into
a fixed pool of KV-cache slots (here fewer slots than requests, so the
engine queues, recycles slots on EOS or budget, and keeps the decode batch
full).  ``--engine static`` serves the batch in one prefill and a fixed
number of decode steps (``repro_torch.launch.serve.serve_batch``).  Runs
the architecture at full width on the CUDA card unless ``--device cpu``,
which serves its reduced variant.

    PYTHONPATH=src python examples/torch/serve_batch.py --arch gemma3-4b
    PYTHONPATH=src python examples/torch/serve_batch.py --batch 8 --slots 2
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.data import tokenizer as tok  # noqa: E402
from repro_torch.launch.serve import (serve_batch,  # noqa: E402
                                      serve_continuous)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2,
                    help="KV-cache slot pool size (continuous engine)")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card at full "
                         "width; 'cpu' serves the reduced variant)")
    args = ap.parse_args()
    reduced = args.device == "cpu"
    prompts = [f"{10+i}+{20+i}=" for i in range(args.batch)]
    if args.engine == "continuous":
        res = serve_continuous(args.arch,
                               [tok.encode(p, bos=True) for p in prompts],
                               reduced=reduced, max_new=args.max_new,
                               num_slots=args.slots, device=args.device)
        print(f"{args.arch} [continuous, {args.slots} slots]: "
              f"{res['tokens']} tokens in {res['wall_s']:.2f}s "
              f"({res['tok_per_s']:.1f} tok/s, slot util "
              f"{res['slot_utilization']:.0%}, random weights)")
    else:
        res = serve_batch(args.arch, prompts, reduced=reduced,
                          max_new=args.max_new, device=args.device)
        print(f"{args.arch} [static]: {res['tokens']} tokens in "
              f"{res['wall_s']:.2f}s ({res['tok_per_s']:.1f} tok/s, "
              f"random weights)")
    for p, t in zip(prompts, res["texts"]):
        print(f"  {p!r} -> {t[:40]!r}")


if __name__ == "__main__":
    main()
