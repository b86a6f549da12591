"""The bfloat16 CT attention forwards and serving head, timed beside
their library calls.

    python -m ct_tpu_torch.scripts.bench_fwd_bf16 [--device cuda|cpu]
        [--batches EVAL TRAIN BENCH] [--anchors P] [--keys K]
        [--widths 15 60] [--iters N] [--json PATH]

Rows 1, 2, 5's forward, 6, 10 and 10's unfused body of PERF.md §6 on
bfloat16 inputs, at ``chip_smoke.py``'s shapes: ``ct_attention_cm_bf16``
(the ``--bf16`` eval forward, batch 8) and ``ct_attention_cm_stats_bf16``
(the ``--bf16`` train step's forward, batch 64) at each width;
``ct_attention_serving_bf16`` (the serving head of ``--int8 --bf16``,
with N = 5 novel classes at C = 15 and 20 otherwise, as the incre and
transfer models have) at each width at the eval batch and at the widest
at the bench's (the JAX bench serves the transfer model at batch 128);
``ct_attention_bf16``, ``ct_attention_variant_bf16`` and
``ct_attention_variant_unfused_bf16`` (the attention bench's, batch 128,
inputs normal × 0.3) at the widest. For each: the mean time of
``--iters`` calls (CUDA events), that of its library call on the same
inputs and their ratio (the bf16 ``scaled_dot_product_attention``, unscaled
scores; for row 6 the unfused head in bf16 library calls, as
``chip_smoke.py`` times it), the device time of each kernel of one call
(torch.profiler, by function name), and each output's distance to its
plain version on the same inputs: max |Δ| in bf16 steps of the largest
entry and the share of entries that differ (m and z: max |Δ| over the
largest). Row 6 at the bench's batch is held on its first 8 images (the
plain version's scores would take 11 GB at batch 128). It calls only the
wrappers of ``ops/ct_attention``, so it times whichever ``ct_tpu_torch``
comes first on ``sys.path``: two trees in turns on one card compare their
kernels on the same inputs (``PYTHONPATH=<tree> python
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


# novel classes of the serving head by width: incre (C=15) 5, else 20
SERVING_NOVEL = {15: 5}
# row 6 at the bench's batch: the images held to the plain version
HELD_IMAGES = 8


def sdpa(q_rm, k, v):
    """The bf16 ``scaled_dot_product_attention`` of q_rm [B, P, C] over k
    and v [B, K, C], unscaled scores: rows 1, 2, 5 and 10's library call."""
    return lambda: F.scaled_dot_product_attention(
        q_rm[:, None], k[:, None], v[:, None], scale=1.0)


def serving_library(conf, k, v, wt, bt, wz, obj):
    """The unfused serving head in bf16 library calls, row-major, scale 5:
    row 6's library call (``chip_smoke.py`` times it too); used nowhere in
    the port."""
    def run():
        x = conf.transpose(1, 2)
        q = torch.matmul(x, wt) + bt.to(BF16) + x
        a = F.scaled_dot_product_attention(q[:, None], k[:, None],
                                           v[:, None], scale=1.0)[:, 0]
        nv = x + a * wz.to(BF16)
        nv = nv * torch.rsqrt((nv * nv).sum(-1, keepdim=True))
        return torch.matmul(nv, obj.t()) * 5.0
    return run


def cases(device, batches, widths, p, kk, seed):
    """(row, C, B, wrapper, arguments, plain version, output names,
    library call, images held to the plain version or None for all) of
    the six forwards on seeded inputs, one at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    # the serving head's inputs from a generator of their own, so that the
    # other rows' inputs do not depend on which rows run
    gen6 = torch.Generator(device=device).manual_seed(seed + 1)

    def f32(*s, scale=1.0, g=gen):
        return torch.randn(s, generator=g, device=device) * scale

    def t(*s, scale=1.0, g=gen):
        return f32(*s, scale=scale, g=g).to(BF16)

    def serving(c, b):
        n = SERVING_NOVEL.get(c, 20)
        args = (t(b, c, p, scale=3.0, g=gen6), t(b, kk, c, scale=0.3, g=gen6),
                t(b, kk, c, g=gen6), t(c, c, scale=0.2, g=gen6),
                f32(c, scale=0.1, g=gen6), f32(c, scale=0.3, g=gen6),
                t(n, c, g=gen6))
        return ("6", c, b, T.ct_attention_serving_bf16, args,
                T.ct_attention_serving_reference_bf16, ("out",),
                serving_library(*args),
                HELD_IMAGES if b > HELD_IMAGES else None)

    for c in widths:
        for row, b, fn, plain, names in (
                ("1", batches[0], T.ct_attention_cm_bf16,
                 T.ct_attention_reference_cm_bf16, ("out",)),
                ("2", batches[1], T.ct_attention_cm_stats_bf16,
                 T.ct_attention_cm_stats_reference_bf16,
                 ("out", "delta", "m", "z"))):
            q, base = t(b, c, p), t(b, c, p)
            args = (q, t(b, kk, c), t(b, kk, c), base, f32(c, scale=0.1))
            yield (row, c, b, fn, args, plain, names,
                   sdpa(q.transpose(1, 2).contiguous(), args[1], args[2]),
                   None)
        yield serving(c, batches[0])
    c, b = max(widths), batches[2]
    yield serving(c, b)
    args = (t(b, p, c, scale=0.3), t(b, kk, c, scale=0.3),
            t(b, kk, c, scale=0.3), t(b, p, c, scale=0.3), f32(c))
    for row, fn, plain in (
            ("5 fwd", T.ct_attention_bf16, T.ct_attention_reference_bf16),
            ("10", T.ct_attention_variant_bf16,
             lambda *a: T.ct_attention_reference_bf16(*a, exp_bf16=True)),
            ("10 unfused", T.ct_attention_variant_unfused_bf16,
             lambda *a: T.ct_attention_reference_bf16(*a, unfused=True))):
        yield (row, c, b, fn, args, plain, ("out",),
               sdpa(args[0], args[1], args[2]), None)


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
        for row, c, b, fn, fargs, plain, names, library, held in cases(
                device, args.batches, args.widths, args.anchors, args.keys,
                args.seed):
            call = lambda: fn(*fargs)
            outs = call()
            outs = outs if isinstance(outs, tuple) else (outs,)
            pargs = fargs
            if held:
                outs = tuple(o[:held] for o in outs)
                pargs = tuple(a[:held] if a.dim() == 3 else a for a in fargs)
            refs = plain(*pargs)
            refs = refs if isinstance(refs, tuple) else (refs,)
            rec = {"row": row, "C": c, "B": b,
                   "ms": mean_ms(call, args.iters, device),
                   "errors": errors(outs, refs, names)}
            if held:
                rec["held_images"] = held
            del outs, refs
            if device.type == "cuda":
                rec["library_ms"] = mean_ms(library, args.iters, device)
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
