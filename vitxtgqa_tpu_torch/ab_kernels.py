"""Time the merged-head flash kernels (#1 forward, its dropout form, and
#1b) of the port package found under --root, for an A/B of two checkouts
on one card (run parent, change, change, parent back to back):

    python3 vitxtgqa_tpu_torch/ab_kernels.py --root DIR [--reps N]

Shapes: #1 at [8, 1152, 768] dec_len 0 (serving), #1 with dropout 0.1 and
#1b at [48, 1152, 768] dec_len 12 (the training step), the key mask of the
synthetic serving batch.  Each time is CUDA events around --reps
back-to-back calls, the median of 5 such runs.  Prints one JSON line with
the card's name and power limit.  Run it as a file, not with -m, so that
the package imported is the one under --root.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p) != os.path.dirname(__file__)]

    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs a CUDA device")
    _build.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    b = synthetic_batch(batch=8, seed=0)
    txt = (torch.arange(20)[None, :] < torch.as_tensor(b["text_len"])[:, None]).float()
    enc = torch.cat([txt, torch.as_tensor(b["frame_mask"]).float(),
                     torch.as_tensor(b["ocr_mask"]).float()], dim=1)
    mask8 = torch.nn.functional.pad(enc, (0, 1152 - enc.shape[1])).to(dev).contiguous()
    mask48 = mask8[torch.arange(48) % 8].clone()
    mask48[:, -12:] = 0.0
    seed = torch.tensor([7], dtype=torch.int64, device=dev)

    def timed(fn):
        for _ in range(3):
            fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(40_000_000)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / args.reps)
        return statistics.median(runs)

    q, k, v = (rn(8, 1152, 768) for _ in range(3))
    out = {"root": args.root,
           "flash_fwd_ms": timed(lambda: FA.flash_attention_merged(q, k, v, mask8, 0, 12))}
    q, k, v, g = (rn(48, 1152, 768) for _ in range(4))
    fwd = lambda: FA.flash_attention_merged(q, k, v, mask48, 12, 12, 0.1, seed, return_lse=True)
    o, lse = fwd()
    out["flash_fwd_dropout_ms"] = timed(fwd)
    out["flash_bwd_ms"] = timed(lambda: FA.flash_attention_merged_bwd(
        q, k, v, mask48, o, lse, g, 12, 12, 0.1, seed))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
