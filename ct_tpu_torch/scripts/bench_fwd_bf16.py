"""The bfloat16 CT attention forwards, timed beside their library call.

    python -m ct_tpu_torch.scripts.bench_fwd_bf16 [--device cuda|cpu]
        [--batches EVAL TRAIN BENCH] [--anchors P] [--keys K]
        [--widths 15 60] [--iters N] [--json PATH]

Rows 1, 2, 5's forward, 10 and 10's unfused body of PERF.md §6 on
bfloat16 inputs, at ``chip_smoke.py``'s shapes: ``ct_attention_cm_bf16``
(the ``--bf16`` eval forward, batch 8) and ``ct_attention_cm_stats_bf16``
(the ``--bf16`` train step's forward, batch 64) at each width;
``ct_attention_bf16``, ``ct_attention_variant_bf16`` and
``ct_attention_variant_unfused_bf16`` (the attention bench's, batch 128,
inputs normal × 0.3) at the widest. For each: the mean time of
``--iters`` calls (CUDA events), that of the bf16
``scaled_dot_product_attention`` on the same inputs (the library call that
computes the same function, unscaled scores) and their ratio, the device
time of each kernel of one call (torch.profiler, by function name), and
each output's distance to its plain version on the same inputs: max |Δ| in
bf16 steps of the largest entry and the share of entries that differ (m
and z: max |Δ| over the largest). It calls only the wrappers of
``ops/ct_attention``, so it times whichever ``ct_tpu_torch`` comes first on
``sys.path``: two trees in turns on one card compare their kernels on the
same inputs (``PYTHONPATH=<tree> python
ct_tpu_torch/scripts/bench_fwd_bf16.py``). ``--device cpu`` runs the plain
versions (host clock, no split, no library time) at tiny sizes.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ct_tpu_torch import resolve_device
from ct_tpu_torch.ops import ct_attention as T
from ct_tpu_torch.scripts import device_name
from ct_tpu_torch.scripts.bench_bwd_bf16 import mean_ms, split_ms

BF16 = torch.bfloat16


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batches", type=int, nargs=3, default=[8, 64, 128],
                    metavar=("EVAL", "TRAIN", "BENCH"),
                    help="rows 1, 2 and the bench's rows 5 and 10")
    ap.add_argument("--anchors", type=int, default=11620)
    ap.add_argument("--keys", type=int, default=1858)
    ap.add_argument("--widths", type=int, nargs="+", default=[15, 60],
                    help="rows 1 and 2 at each; 5 and 10 at the widest")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write the result here")
    return ap.parse_args(argv)


def cases(device, batches, widths, p, kk, seed):
    """(row, C, B, wrapper, arguments, plain version, output names, q
    row-major) of the five forwards on seeded inputs, one at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def t(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=device) * scale).to(BF16)

    for c in widths:
        for row, b, fn, plain, names in (
                ("1", batches[0], T.ct_attention_cm_bf16,
                 T.ct_attention_reference_cm_bf16, ("out",)),
                ("2", batches[1], T.ct_attention_cm_stats_bf16,
                 T.ct_attention_cm_stats_reference_bf16,
                 ("out", "delta", "m", "z"))):
            q, base = t(b, c, p), t(b, c, p)
            args = (q, t(b, kk, c), t(b, kk, c), base,
                    torch.randn(c, generator=gen, device=device) * 0.1)
            yield (row, c, b, fn, args, plain, names,
                   q.transpose(1, 2).contiguous())
    c, b = max(widths), batches[2]
    args = (t(b, p, c, scale=0.3), t(b, kk, c, scale=0.3),
            t(b, kk, c, scale=0.3), t(b, p, c, scale=0.3),
            torch.randn(c, generator=gen, device=device))
    for row, fn, plain in (
            ("5 fwd", T.ct_attention_bf16, T.ct_attention_reference_bf16),
            ("10", T.ct_attention_variant_bf16,
             lambda *a: T.ct_attention_reference_bf16(*a, exp_bf16=True)),
            ("10 unfused", T.ct_attention_variant_unfused_bf16,
             lambda *a: T.ct_attention_reference_bf16(*a, unfused=True))):
        yield row, c, b, fn, args, plain, ("out",), args[0]


def errors(outs, plains, names) -> dict:
    res = {}
    for n, a, r in zip(names, outs, plains):
        a, r = a.float(), r.float()
        d = (a - r).abs()
        top = r.abs().max().item()
        res[n] = ({"max_rel": d.max().item() / top} if n in ("m", "z") else
                  {"max_steps": d.max().item() / T.bf16_step(top),
                   "differing_share": (a != r).float().mean().item()})
    return res


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    res = {"device": device_name(device), "anchors": args.anchors,
           "keys": args.keys, "package": T.__file__, "rows": []}
    with torch.no_grad():
        for row, c, b, fn, fargs, plain, names, q_rm in cases(
                device, args.batches, args.widths, args.anchors, args.keys,
                args.seed):
            call = lambda: fn(*fargs)
            outs = call()
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = plain(*fargs)
            refs = refs if isinstance(refs, tuple) else (refs,)
            rec = {"row": row, "C": c, "B": b,
                   "ms": mean_ms(call, args.iters, device),
                   "errors": errors(outs, refs, names)}
            del outs, refs
            if device.type == "cuda":
                k4, v4 = fargs[1][:, None], fargs[2][:, None]
                rec["library_ms"] = mean_ms(
                    lambda: F.scaled_dot_product_attention(
                        q_rm[:, None], k4, v4, scale=1.0), args.iters, device)
                rec["x_library"] = rec["ms"] / rec["library_ms"]
                rec["kernels_ms"] = split_ms(call)
                torch.cuda.empty_cache()
            print(json.dumps(rec), flush=True)
            res["rows"].append(rec)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
