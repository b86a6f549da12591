"""Context-Transformer attention: CUDA kernels + plain versions.

The port of the CT attention of ``ct_tpu/ops/ct_attention.py``. Per image,

    out = base + softmax_K(kᵀ q) · v · wz

with q = θ(conf) + conf over all P anchors (11,620 at 300), k/v over the K
max-pooled context anchors (1,858 at 300) and C source classes (15 incre,
60 transfer). k and v are [B, K, C]; q, base and out are class-major
[B, C, P] on the model's path (``ct_attention_cm``) and row-major
[B, P, C] in ``ct_attention``, the layout the JAX package's kernel benches
use.

Each kernel sits behind a wrapper that launches it for CUDA tensors, takes
its plain PyTorch version for CPU tensors, and counts its launches in
``<wrapper>.launches``:

* ``ct_attention_cm`` (``csrc/ct_attention_cm.cu``): the class-major
  forward alone, for calls that need no gradient and for the blockwise
  training forward;
* ``ct_attention_cm_stats`` (same source): the training forward, which
  also returns delta = softmax·v, the row max m and the denominator z;
* ``ct_attention_cm_bwd_flash`` (``csrc/ct_attention_cm_bwd.cu``): dq, dk
  and dv from the saved m and z and the softmax-Jacobian term colsum;
* ``ct_attention_cm_bwd`` (same source): the blockwise backward of
  ``_bwd_call_cm``, dq, dk, dv and dwz from q, k, v, wz and g alone;
* ``ct_attention`` and ``ct_attention_bwd`` (the same two sources, their
  row-major layout): the row-major forward and blockwise backward;
* ``ct_attention_variant`` (``csrc/ct_attention_cm.cu``): the row-major
  forward with its exponential rounded as a bfloat16 one, the attention
  bench's bfloat16 variant.

``ct_attention_cm`` is the model's entry: with no gradient to take it runs
the eval kernel; otherwise it goes through an autograd Function whose
forward is the stats kernel and whose backward is the flash kernel or,
with ``flash=False`` (the reference's ``CT_ATTENTION_FLASH=0``), whose
forward is the eval kernel and whose backward is the blockwise kernel; on
the card and (through their plain versions) on the CPU alike.
``ct_attention`` is differentiable in the same way, with the row-major
backward.

The serving path's fused head is ``ct_attention_serving``
(``csrc/ct_attention_serving.cu``), the port of the JAX package's
``ct_attention_serving``: the θ projection, the same attention, the
residual, the ℓ2 normalisation and the cosine classifier in one pass, from
the class-major conf [B, C, P] to scores [B, N, P]. Forward only, as in the
JAX package.

bfloat16: ``ct_attention_cm``, ``ct_attention``, ``ct_attention_variant``
and ``ct_attention_serving`` also take bf16 q, k, v and base (conf, Wθ and
OBJ_Target for the serving head) with float32 wz (and bθ), as the JAX
package's ``--bf16`` models call them, and return bf16. They compute what
the JAX kernels compute on bf16 operands: f32 scores from bf16 products,
the weights e = exp(s − max s) rounded to bf16 before P·V, the denominator
Σ e of those rounded weights in f32, the output rounded to bf16 (and the
serving head's q and normalised novel rounded where JAX rounds them). CUDA
tensors go to the bf16 kernels, counted on ``ct_attention_cm_bf16.launches``
and its siblings, all on warpgroup ``wgmma`` tiles after the prep of k and
v into the tile layout that they share with the bf16 backwards
(``prep_kv`` in ``csrc/ct_attention_wgmma.cuh``): the forwards
(``csrc/ct_attention_cm.cu``) and the serving head
(``csrc/ct_attention_serving.cu``: θ as one product of the staged conf and
Wθ tiles, then the forwards' two walks over the keys, ``wg::walk``); CPU
tensors to the plain bf16 versions.
``ct_attention_variant_unfused_bf16`` is the attention bench's one bf16
body that divides by another sum: its unfused float32-exponent variant,
whose denominator is Σ e of the float32 weights before their rounding (the
kernel sums them beside its product).

``ct_attention_cm`` and ``ct_attention`` are differentiable in bf16 too,
as ``train.py --bf16`` trains (``_fwd_cm``/``_bwd_cm`` on bf16 operands):
the flash forward ``ct_attention_cm_stats_bf16`` (delta saved in bf16, m
and z in f32) and backward ``ct_attention_cm_bwd_flash_bf16``, the
blockwise backward ``ct_attention_cm_bwd_bf16`` and the row-major one
``ct_attention_bwd_bf16`` (``csrc/ct_attention_bwd_bf16.cu``), each with a
plain version that rounds where the JAX kernel rounds (listed in the
source's note). dq comes back bf16, dk and dv as f32 sums that the
autograd rounds to bf16, as ``_bwd_cm`` casts them, and dwz f32. The types
must agree: bf16 q, k, v and base with f32 wz, or all f32.
"""

from __future__ import annotations

import math

import torch

from ct_tpu_torch import kernels

MAX_CLASSES = 64   # the kernel's widest padded class count


def ct_attention_reference_cm(
    q_cm: torch.Tensor,     # [B, C, P]
    k: torch.Tensor,        # [B, K, C]
    v: torch.Tensor,        # [B, K, C]
    base_cm: torch.Tensor,  # [B, C, P]
    wz: torch.Tensor,       # [C]
) -> torch.Tensor:
    """The plain version: materializes the [B, K, P] affinity."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q_cm.float())
    attn = torch.softmax(s, dim=1)
    delta = torch.einsum("bkp,bkc->bcp", attn, v.float())
    return base_cm + delta * wz[None, :, None]


BF16 = torch.bfloat16


def bf16_step(x: float) -> float:
    """One bfloat16 step at |x|: 2^(⌊log2 |x|⌋ − 7), between 2⁻⁸·|x| and
    2⁻⁷·|x| (8 significant bits). The band of the bf16 kernels against
    their plain versions is one step at the largest output: the two sum
    in another f32 order, and where a value lies that close to a rounding
    boundary its bf16 result moves by one step."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def _weighted_bf16(s, v):
    """The bf16 kernels' attention on f32 scores s [B, K, P] and bf16 values
    v [B, K, C] → delta [B, C, P] f32: e = exp(s − max s) rounded to bf16,
    Σ e·v over Σ e, both in f32 (the ones column of v in the JAX kernel)."""
    e = torch.exp(s - s.amax(dim=1, keepdim=True)).to(BF16).float()
    return torch.einsum("bkp,bkc->bcp", e, v.float()) / e.sum(dim=1,
                                                              keepdim=True)


def ct_attention_reference_cm_bf16(q_cm, k, v, base_cm, wz):
    """The plain bf16 class-major forward (the JAX ``_kernel_cm`` on bf16
    operands) → [B, C, P] bf16."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q_cm.float())
    out = base_cm.float() + _weighted_bf16(s, v) * wz[None, :, None]
    return out.to(BF16)


def _padded_classes(c: int) -> int:
    """The bf16 kernels' class count: C and the ones column (csrc
    ``padded_classes``)."""
    return 16 if c < 16 else 64


# the bf16 kernels' tile of anchors and of keys (csrc wg::kTile): their
# scratch holds whole tiles, and the backward's stats pass one dwz partial
# sum a tile of anchors
BF16_TILE = 64


def _whole_tiles(n: int) -> int:
    return -(-n // BF16_TILE) * BF16_TILE


def _kv_scratch_bf16(q, b, c, kk):
    """k and v in the bf16 kernels' tile layout: [2, B, Kp, CP] bf16."""
    return q.new_empty((2, b, _whole_tiles(kk), _padded_classes(c)))


def prep_kv_reference_bf16(k, v, ones: bool):
    """The plain version of the bf16 kernels' prep (csrc ``prep_kv``): k
    and v [B, K, C] → [B, Kp, CP] each, zero past C and K (Kp = K rounded
    up to whole tiles), v's column C one for each live key with ``ones``,
    and within each row the 16-byte chunks (8 classes) permuted as the
    tiles' swizzle places them (``wg::chunk_at``: chunk c of row r at c ^
    (r % 8) for CP = 64, c ^ ((r / 4) % 2) for CP = 16)."""
    b, kk, c = k.shape
    cp, kp = _padded_classes(c), _whole_tiles(kk)
    padded = k.new_zeros((2, b, kp, cp))
    padded[0, :, :kk, :c] = k
    padded[1, :, :kk, :c] = v
    if ones:
        padded[1, :, :kk, c] = 1
    r = torch.arange(kp)[:, None]
    chunk = torch.arange(cp)[None, :] // 8
    swz = chunk ^ (r % 8) if cp == 64 else chunk ^ ((r // 4) % 2)
    # the chunk permutation is its own inverse: the class at position
    # (r, d) is class 8·swz(r, d // 8) + d % 8
    src = (swz * 8 + torch.arange(cp)[None, :] % 8).to(k.device)
    out = padded.gather(3, src.expand(2, b, kp, cp))
    return out[0], out[1]


def ct_attention_prep_kv_bf16(k, v, ones: bool):
    """The bf16 kernels' prep alone → (kp, vp), [B, Kp, CP] bf16 each, for
    its card test. CUDA tensors go to the kernel, counted on
    ``ct_attention_prep_kv_bf16.launches``; CPU tensors to the plain
    version."""
    if (k.dtype != BF16 or v.dtype != BF16 or k.shape != v.shape
            or k.dim() != 3 or not 0 < k.shape[2] < MAX_CLASSES):
        raise ValueError("ct_attention_prep_kv_bf16: k and v must be bf16 "
                         "[B, K, C] of one shape, C at most 63")
    if _device("ct_attention_prep_kv_bf16", k) == "cpu":
        return prep_kv_reference_bf16(k, v, ones)
    b, kk, c = k.shape
    scratch = _kv_scratch_bf16(k, b, c, kk)
    kernels.launch(ct_attention_prep_kv_bf16, "ct_attention_prep_kv_bf16",
                   (k, v, scratch[0], scratch[1]), (b, c, kk, int(ones)))
    return scratch[0], scratch[1]


ct_attention_prep_kv_bf16.launches = 0


def _launch_bf16(wrapper, q, k, v, base, wz, row_major: bool):
    """Launch a bf16 attention forward, with its scratch for k and v in
    the tile layout allocated here → out, bf16 like base."""
    b, p, c = q.shape if row_major else (q.shape[0], q.shape[2], q.shape[1])
    kk = k.shape[1]
    out = torch.empty_like(base)
    kernels.launch(wrapper, wrapper.__name__,
                   (q, k, v, base, wz, out, _kv_scratch_bf16(q, b, c, kk)),
                   (b, c, p, kk))
    return out


def ct_attention_cm_bf16(q_cm, k, v, base_cm, wz) -> torch.Tensor:
    """The bf16 class-major eval forward → [B, C, P] bf16.
    CUDA tensors go to the kernel, counted on
    ``ct_attention_cm_bf16.launches``; CPU tensors to the plain version."""
    _check(q_cm, k, v, base_cm, wz, "ct_attention_cm_bf16")
    if q_cm.dtype != BF16:
        raise TypeError(f"ct_attention_cm_bf16: q_cm is {q_cm.dtype}")
    if _device("ct_attention_cm_bf16", q_cm) == "cpu":
        return ct_attention_reference_cm_bf16(q_cm, k, v, base_cm, wz)
    return _launch_bf16(ct_attention_cm_bf16, q_cm, k, v, base_cm, wz, False)


ct_attention_cm_bf16.launches = 0


def _check(q, k, v, base, wz, fn: str = "ct_attention_cm",
           row_major: bool = False):
    """Raise on what the kernels do not take: q and base [B, C, P] (or
    [B, P, C] with ``row_major``), k and v [B, K, C], wz [C], on one
    device; q, k, v and base all float32, C at most 64, or all bfloat16
    with wz float32, C at most 63 (the bf16 kernels' ones column)."""
    names = (("q", "k", "v", "base", "wz") if row_major
             else ("q_cm", "k", "v", "base_cm", "wz"))
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: {names[0]} is {dt}, the kernels take "
                        "float32 or bfloat16")
    for name, t in zip(names, (q, k, v, base, wz)):
        want = torch.float32 if name == "wz" else dt
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} is {t.dtype}; with {names[0]} "
                            f"{dt} the kernel takes {want}")
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"q on {q.device}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"{fn}: q must be "
                         f"{'[B, P, C]' if row_major else '[B, C, P]'} and "
                         "k [B, K, C]")
    if row_major:
        b, p, c = q.shape
    else:
        b, c, p = q.shape
    kk = k.shape[1]
    if (base.shape != q.shape or tuple(k.shape) != (b, kk, c)
            or tuple(v.shape) != (b, kk, c) or tuple(wz.shape) != (c,)):
        raise ValueError(
            f"{fn}: shapes disagree: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"base {tuple(base.shape)}, wz {tuple(wz.shape)}")
    if min(b, c, p, kk) < 1:
        raise ValueError(f"{fn}: empty input")
    most = MAX_CLASSES - (dt == torch.bfloat16)
    if c > most:
        raise ValueError(f"{fn}: C={c} exceeds the {dt} kernel's "
                         f"{most} classes")


def ct_attention_cm_stats_reference(q_cm, k, v, base_cm, wz):
    """The plain training forward → (out, delta [B,C,P], m, z [B,1,P])."""
    s = torch.einsum("bkc,bcp->bkp", k, q_cm)
    m = s.amax(dim=1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=1, keepdim=True)
    delta = torch.einsum("bkp,bkc->bcp", e, v) / z
    return base_cm + delta * wz[None, :, None], delta, m, z


def ct_attention_cm_bwd_flash_reference(q_cm, k, v, wz, g_cm, m, z, colsum):
    """The plain flash backward → (dq [B,C,P], dk [B,K,C], dv [B,K,C]),
    with the [B, K, P] attention materialized."""
    s = torch.einsum("bkc,bcp->bkp", k, q_cm)
    attn = torch.exp(s - m) / z
    gw = g_cm * wz[None, :, None]
    dattn = torch.einsum("bkc,bcp->bkp", v, gw)
    ds = attn * (dattn - colsum)
    dq = torch.einsum("bkc,bkp->bcp", k, ds)
    dk = torch.einsum("bcp,bkp->bkc", q_cm, ds)
    dv = torch.einsum("bcp,bkp->bkc", gw, attn)
    return dq, dk, dv


def ct_attention_cm_bwd_reference(q_cm, k, v, wz, g_cm):
    """The plain blockwise backward → (dq [B,C,P], dk [B,K,C], dv [B,K,C],
    dwz [C]) from q, k, v, wz and g alone, as the JAX package's
    ``_bwd_kernel_cm`` computes it, with the [B, K, P] attention
    materialized."""
    s = torch.einsum("bkc,bcp->bkp", k, q_cm)
    attn = torch.softmax(s, dim=1)
    gw = g_cm * wz[None, :, None]
    dv = torch.einsum("bcp,bkp->bkc", gw, attn)
    dattn = torch.einsum("bkc,bcp->bkp", v, gw)
    colsum = (attn * dattn).sum(dim=1, keepdim=True)
    ds = attn * (dattn - colsum)
    dq = torch.einsum("bkc,bkp->bcp", k, ds)
    dk = torch.einsum("bcp,bkp->bkc", q_cm, ds)
    delta = torch.einsum("bkc,bkp->bcp", v, attn)
    return dq, dk, dv, (g_cm * delta).sum(dim=(0, 2))


def _device(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {t.device}")
    return t.device.type


def ct_attention_cm_stats(q_cm, k, v, base_cm, wz):
    """Training forward → (out [B,C,P], delta [B,C,P], m [B,1,P],
    z [B,1,P]), float32; the kernel on CUDA tensors, else the plain
    version. bf16 inputs go to ``ct_attention_cm_stats_bf16``."""
    _check(q_cm, k, v, base_cm, wz)
    if q_cm.dtype == BF16:
        return ct_attention_cm_stats_bf16(q_cm, k, v, base_cm, wz)
    if _device("ct_attention_cm_stats", q_cm) == "cpu":
        return ct_attention_cm_stats_reference(q_cm, k, v, base_cm, wz)
    b, c, p = q_cm.shape
    out = torch.empty_like(base_cm)
    delta = torch.empty_like(base_cm)
    m = q_cm.new_empty((b, 1, p))
    z = q_cm.new_empty((b, 1, p))
    kernels.launch(ct_attention_cm_stats, "ct_attention_cm_stats",
                   (q_cm, k, v, base_cm, wz, out, delta, m, z),
                   (b, c, p, k.shape[1]))
    return out, delta, m, z


def ct_attention_cm_bwd_flash(q_cm, k, v, wz, g_cm, m, z, colsum):
    """Flash backward → (dq [B,C,P], dk [B,K,C], dv [B,K,C]) from the saved
    row max ``m`` and denominator ``z`` and ``colsum`` = Σ_c g·delta·wz,
    all [B,1,P] float32; the kernel on CUDA tensors, else the plain
    version. bf16 inputs go to ``ct_attention_cm_bwd_flash_bf16``."""
    _check(q_cm, k, v, g_cm, wz)
    _check_stats("ct_attention_cm_bwd_flash", q_cm, m, z, colsum)
    if q_cm.dtype == BF16:
        return ct_attention_cm_bwd_flash_bf16(q_cm, k, v, wz, g_cm, m, z,
                                              colsum)
    if _device("ct_attention_cm_bwd_flash", q_cm) == "cpu":
        return ct_attention_cm_bwd_flash_reference(q_cm, k, v, wz, g_cm, m,
                                                   z, colsum)
    b, c, p = q_cm.shape
    dq = torch.empty_like(q_cm)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    kernels.launch(ct_attention_cm_bwd_flash, "ct_attention_cm_bwd_flash",
                   (q_cm, k, v, wz, g_cm, m, z, colsum, dq, dk, dv),
                   (b, c, p, k.shape[1]))
    return dq, dk, dv


ANCHORS_PER_BLOCK = 64   # the kernels' block of anchors (csrc kRows)


def _blockwise_bwd(wrapper, q, k, v, wz, g, row_major: bool):
    """Launch a blockwise backward kernel (class-major or row-major q, g):
    → (dq like q, dk, dv [B,K,C], dwz [C]), with its scratch (m, z, colsum
    and the per-block partial sums of dwz) allocated here."""
    b, p, c = q.shape if row_major else (q.shape[0], q.shape[2], q.shape[1])
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dwz = wz.new_empty((c,))
    m, z, colsum = (q.new_empty((b, p)) for _ in range(3))
    part = q.new_empty((b, -(-p // ANCHORS_PER_BLOCK), c))
    kernels.launch(wrapper, wrapper.__name__,
                   (q, k, v, wz, g, dq, dk, dv, dwz, m, z, colsum, part),
                   (b, c, p, k.shape[1]))
    return dq, dk, dv, dwz


def ct_attention_cm_bwd(q_cm, k, v, wz, g_cm):
    """Blockwise (non-flash) backward → (dq [B,C,P], dk [B,K,C],
    dv [B,K,C], dwz [C]) from q, k, v, wz and the upstream gradient alone,
    as ``_bwd_call_cm`` takes them; the kernel on CUDA tensors, else the
    plain version. bf16 inputs go to ``ct_attention_cm_bwd_bf16``."""
    _check(q_cm, k, v, g_cm, wz, "ct_attention_cm_bwd")
    if q_cm.dtype == BF16:
        return ct_attention_cm_bwd_bf16(q_cm, k, v, wz, g_cm)
    if _device("ct_attention_cm_bwd", q_cm) == "cpu":
        return ct_attention_cm_bwd_reference(q_cm, k, v, wz, g_cm)
    return _blockwise_bwd(ct_attention_cm_bwd, q_cm, k, v, wz, g_cm, False)


def _check_stats(fn, q_cm, m, z, colsum):
    b, c, p = q_cm.shape
    for name, t in (("m", m), ("z", z), ("colsum", colsum)):
        if (tuple(t.shape) != (b, 1, p) or t.dtype != torch.float32
                or t.device != q_cm.device):
            raise ValueError(f"{fn}: {name} must be float32 [{b}, 1, {p}] "
                             f"on {q_cm.device}")


# --- bfloat16 training: rows 2, 3, 4 and 5's backward ----------------------

def ct_attention_cm_stats_reference_bf16(q_cm, k, v, base_cm, wz):
    """The plain bf16 training forward (``_kernel_cm_stats`` on bf16
    operands) → (out bf16, delta bf16 [B,C,P], m, z f32 [B,1,P]): f32
    scores, the weights rounded to bf16 against the row max m, z their f32
    sum, delta = Σ e·v / z in f32, rounded to bf16 once for out (with base
    and wz) and once for itself."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q_cm.float())
    m = s.amax(dim=1, keepdim=True)
    e = torch.exp(s - m).to(BF16).float()
    z = e.sum(dim=1, keepdim=True)
    delta = torch.einsum("bkp,bkc->bcp", e, v.float()) / z
    out = base_cm.float() + delta * wz[None, :, None]
    return out.to(BF16), delta.to(BF16), m, z


def ct_attention_cm_bwd_flash_reference_bf16(q_cm, k, v, wz, g_cm, m, z,
                                             colsum):
    """The plain bf16 flash backward (``_bwd_kernel_cm_flash`` on bf16
    operands) → (dq bf16 [B,C,P], dk, dv f32 [B,K,C]): attn = e^(s−m)·(1/z)
    unrounded; g·wz rounded to bf16 before both its products; ds =
    bf16(attn·(dattn − colsum)); dv from the bf16-rounded attn."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q_cm.float())
    attn = torch.exp(s - m) * (1.0 / z)
    gv = (g_cm.float() * wz[None, :, None]).to(BF16).float()
    dattn = torch.einsum("bkc,bcp->bkp", v.float(), gv)
    ds = (attn * (dattn - colsum)).to(BF16).float()
    dq = torch.einsum("bkc,bkp->bcp", k.float(), ds).to(BF16)
    dk = torch.einsum("bcp,bkp->bkc", q_cm.float(), ds)
    dv = torch.einsum("bcp,bkp->bkc", gv, attn.to(BF16).float())
    return dq, dk, dv


def ct_attention_cm_bwd_reference_bf16(q_cm, k, v, wz, g_cm,
                                       divide: bool = False,
                                       round_dq: bool = True):
    """The plain bf16 blockwise backward (``_bwd_kernel_cm`` on bf16
    operands; with ``divide`` the row-major ``_bwd_kernel``'s weights,
    e / Σe where the class-major kernel takes e·(1/Σe)) → (dq bf16
    [B,C,P], dk, dv f32 [B,K,C], dwz f32 [C]): the weights normalised by
    the sum of the unrounded exponentials, then rounded to bf16 (af); g·wz
    rounded to bf16; colsum = Σ_K af·dattn; ds = bf16(af·(dattn −
    colsum)); dwz = Σ g·delta with delta = Σ_K af·v."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q_cm.float())
    e = torch.exp(s - s.amax(dim=1, keepdim=True))
    total = e.sum(dim=1, keepdim=True)
    attn = e / total if divide else e * (1.0 / total)
    af = attn.to(BF16).float()
    g = g_cm.float()
    gv = (g * wz[None, :, None]).to(BF16).float()
    dv = torch.einsum("bcp,bkp->bkc", gv, af)
    dattn = torch.einsum("bkc,bcp->bkp", v.float(), gv)
    colsum = (af * dattn).sum(dim=1, keepdim=True)
    ds = (af * (dattn - colsum)).to(BF16).float()
    dq = torch.einsum("bkc,bkp->bcp", k.float(), ds)
    dk = torch.einsum("bcp,bkp->bkc", q_cm.float(), ds)
    delta = torch.einsum("bkc,bkp->bcp", v.float(), af)
    if round_dq:
        dq = dq.to(BF16)
    return dq, dk, dv, (g * delta).sum(dim=(0, 2))


def ct_attention_bwd_reference_bf16(q, k, v, wz, g):
    """The plain bf16 row-major blockwise backward (``_bwd_kernel`` on bf16
    operands, as scripts/bench_ct_bwd.py's wrapper calls it) → (dq, dk, dv,
    dwz), all float32: that wrapper declares dq float32, so it is not
    rounded."""
    dq, dk, dv, dwz = ct_attention_cm_bwd_reference_bf16(
        q.transpose(1, 2), k, v, wz, g.transpose(1, 2), divide=True,
        round_dq=False)
    return dq.transpose(1, 2), dk, dv, dwz


def _bf16_only(fn, t):
    if t.dtype != BF16:
        raise TypeError(f"{fn}: {t.dtype}; this is the bfloat16 kernel")


def ct_attention_cm_stats_bf16(q_cm, k, v, base_cm, wz):
    """The bf16 training forward → (out bf16, delta bf16 [B,C,P], m, z
    float32 [B,1,P]). CUDA tensors go to the kernel (the bf16 forward with
    a statistics epilogue), counted on ``ct_attention_cm_stats_bf16
    .launches``; CPU tensors to the plain version."""
    _check(q_cm, k, v, base_cm, wz, "ct_attention_cm_stats_bf16")
    _bf16_only("ct_attention_cm_stats_bf16", q_cm)
    if _device("ct_attention_cm_stats_bf16", q_cm) == "cpu":
        return ct_attention_cm_stats_reference_bf16(q_cm, k, v, base_cm, wz)
    b, c, p = q_cm.shape
    kk = k.shape[1]
    out = torch.empty_like(base_cm)
    delta = torch.empty_like(base_cm)
    m = wz.new_empty((b, 1, p))
    z = wz.new_empty((b, 1, p))
    kernels.launch(ct_attention_cm_stats_bf16, "ct_attention_cm_stats_bf16",
                   (q_cm, k, v, base_cm, wz, out, delta, m, z,
                    _kv_scratch_bf16(q_cm, b, c, kk)), (b, c, p, kk))
    return out, delta, m, z


def _bwd_scratch_bf16(q, b, c, p, kk, planes: int):
    """The bf16 backwards' scratch, in the kernels' tile layout: k and v
    [2, B, Kp, CP], q, g·wz and (``planes`` 3, the blockwise stats pass) g
    [planes, B, Pp, CP] in bf16, the statistics [4, B, Pp] in float32 (CP
    the walk's padded classes, Kp and Pp = K and P rounded up to whole
    tiles)."""
    cp = _padded_classes(c)
    pp = _whole_tiles(p)
    return (_kv_scratch_bf16(q, b, c, kk), q.new_empty((planes, b, pp, cp)),
            q.new_empty((4, b, pp), dtype=torch.float32))


def ct_attention_cm_bwd_flash_bf16(q_cm, k, v, wz, g_cm, m, z, colsum):
    """The bf16 flash backward → (dq bf16 [B,C,P], dk, dv float32
    [B,K,C]) from the saved m and z and colsum = Σ_c g·delta·wz, all
    float32 [B,1,P]. CUDA tensors go to the kernels, counted on
    ``ct_attention_cm_bwd_flash_bf16.launches``; CPU tensors to the plain
    version."""
    _check(q_cm, k, v, g_cm, wz, "ct_attention_cm_bwd_flash_bf16")
    _bf16_only("ct_attention_cm_bwd_flash_bf16", q_cm)
    _check_stats("ct_attention_cm_bwd_flash_bf16", q_cm, m, z, colsum)
    if _device("ct_attention_cm_bwd_flash_bf16", q_cm) == "cpu":
        return ct_attention_cm_bwd_flash_reference_bf16(q_cm, k, v, wz, g_cm,
                                                        m, z, colsum)
    b, c, p = q_cm.shape
    kk = k.shape[1]
    dq = torch.empty_like(q_cm)
    dk = wz.new_empty((b, kk, c))
    dv = wz.new_empty((b, kk, c))
    kernels.launch(ct_attention_cm_bwd_flash_bf16,
                   "ct_attention_cm_bwd_flash_bf16",
                   (q_cm, k, v, wz, g_cm, m, z, colsum, dq, dk, dv,
                    *_bwd_scratch_bf16(q_cm, b, c, p, kk, 2)), (b, c, p, kk))
    return dq, dk, dv


def _blockwise_bwd_bf16(wrapper, q, k, v, wz, g, row_major: bool):
    """Launch a bf16 blockwise backward (class-major or row-major q, g) →
    (dq like q, bf16 class-major and float32 row-major, dk, dv float32
    [B,K,C], dwz [C]), with its scratch."""
    b, p, c = q.shape if row_major else (q.shape[0], q.shape[2], q.shape[1])
    kk = k.shape[1]
    dq = torch.empty_like(q, dtype=torch.float32 if row_major else BF16)
    dk = wz.new_empty((b, kk, c))
    dv = wz.new_empty((b, kk, c))
    dwz = wz.new_empty((c,))
    kvp, qg, stats = _bwd_scratch_bf16(q, b, c, p, kk, 3)
    part = wz.new_empty((b * stats.shape[2] // BF16_TILE, c))
    kernels.launch(wrapper, wrapper.__name__,
                   (q, k, v, wz, g, dq, dk, dv, dwz, kvp, qg, stats, part),
                   (b, c, p, kk))
    return dq, dk, dv, dwz


def ct_attention_cm_bwd_bf16(q_cm, k, v, wz, g_cm):
    """The bf16 blockwise backward (``CT_ATTENTION_FLASH=0``) → (dq bf16
    [B,C,P], dk, dv float32 [B,K,C], dwz float32 [C]) from q, k, v, wz
    and g alone. CUDA tensors go to the kernels, counted on
    ``ct_attention_cm_bwd_bf16.launches``; CPU tensors to the plain
    version."""
    _check(q_cm, k, v, g_cm, wz, "ct_attention_cm_bwd_bf16")
    _bf16_only("ct_attention_cm_bwd_bf16", q_cm)
    if _device("ct_attention_cm_bwd_bf16", q_cm) == "cpu":
        return ct_attention_cm_bwd_reference_bf16(q_cm, k, v, wz, g_cm)
    return _blockwise_bwd_bf16(ct_attention_cm_bwd_bf16, q_cm, k, v, wz,
                               g_cm, False)


def ct_attention_bwd_bf16(q, k, v, wz, g):
    """The bf16 row-major blockwise backward (the JAX ``_bwd_kernel`` that
    scripts/bench_ct_bwd.py feeds bf16) → (dq [B,P,C], dk, dv, dwz), all
    float32 as that bench's wrapper emits them. CUDA tensors go to the
    kernels, counted on
    ``ct_attention_bwd_bf16.launches``; CPU tensors to the plain
    version."""
    _check(q, k, v, g, wz, "ct_attention_bwd_bf16", row_major=True)
    _bf16_only("ct_attention_bwd_bf16", q)
    if _device("ct_attention_bwd_bf16", q) == "cpu":
        return ct_attention_bwd_reference_bf16(q, k, v, wz, g)
    return _blockwise_bwd_bf16(ct_attention_bwd_bf16, q, k, v, wz, g, True)


def ct_attention_bwd_bf16_division(e, l):
    """Row 5's weight division alone, e / l on float32 tensors of one shape
    → (the bf16 backward kernels' quotient, ``__fdiv_rn``'s), for the card
    test that holds the two to the same bits. CUDA tensors go to the
    source's test entry point, counted on
    ``ct_attention_bwd_bf16_division.launches``; CPU tensors to the plain
    version, e / l twice."""
    if e.shape != l.shape or e.dtype != torch.float32 or \
            l.dtype != torch.float32 or e.device != l.device:
        raise ValueError("ct_attention_bwd_bf16_division: e and l must be "
                         "float32 of one shape on one device")
    if _device("ct_attention_bwd_bf16_division", e) == "cpu":
        return e / l, e / l
    out, ref = torch.empty_like(e), torch.empty_like(e)
    kernels.launch(ct_attention_bwd_bf16_division,
                   "ct_attention_bwd_bf16_division",
                   (e.contiguous(), l.contiguous(), out, ref), (e.numel(),))
    return out, ref


for _fn in (ct_attention_cm_stats, ct_attention_cm_bwd_flash,
            ct_attention_cm_bwd, ct_attention_cm_stats_bf16,
            ct_attention_cm_bwd_flash_bf16, ct_attention_cm_bwd_bf16,
            ct_attention_bwd_bf16, ct_attention_bwd_bf16_division):
    _fn.launches = 0


class _CTAttentionCM(torch.autograd.Function):
    """``ct_attention_cm`` with the flash backward (the JAX package's
    ``_fwd_cm``/``_bwd_cm`` with ``CT_ATTENTION_FLASH`` at its default)."""

    @staticmethod
    def forward(ctx, q_cm, k, v, base_cm, wz):
        out, delta, m, z = ct_attention_cm_stats(q_cm, k, v, base_cm, wz)
        ctx.save_for_backward(q_cm, k, v, wz, delta, m, z)
        return out

    @staticmethod
    def backward(ctx, g_cm):
        q_cm, k, v, wz, delta, m, z = ctx.saved_tensors
        g_cm = g_cm.contiguous()
        # dwz and the softmax-Jacobian term come from the saved delta, as
        # the JAX package computes them outside its kernel, in float32
        gd = g_cm.float() * delta.float()
        dwz = gd.sum(dim=(0, 2))
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        dq, dk, dv = ct_attention_cm_bwd_flash(q_cm, k, v, wz, g_cm, m, z,
                                               colsum)
        # d/d(base) of base + delta·wz is the upstream gradient itself; dk
        # and dv (f32 sums) in k's and v's type, as ``_bwd_cm`` casts them
        return dq, dk.to(k.dtype), dv.to(v.dtype), g_cm, dwz


class _CTAttentionCMBlockwise(torch.autograd.Function):
    """``ct_attention_cm`` with the blockwise backward (the JAX package's
    ``_fwd_cm``/``_bwd_cm`` with ``CT_ATTENTION_FLASH=0``): the eval
    forward, saving only its inputs, and a backward that recomputes the
    softmax."""

    @staticmethod
    def forward(ctx, q_cm, k, v, base_cm, wz):
        ctx.save_for_backward(q_cm, k, v, wz)
        return _cm_forward(q_cm, k, v, base_cm, wz)

    @staticmethod
    def backward(ctx, g_cm):
        q_cm, k, v, wz = ctx.saved_tensors
        g_cm = g_cm.contiguous()
        dq, dk, dv, dwz = ct_attention_cm_bwd(q_cm, k, v, wz, g_cm)
        return dq, dk.to(k.dtype), dv.to(v.dtype), g_cm, dwz


def _cm_forward(q_cm, k, v, base_cm, wz):
    """The eval forward: the kernel on CUDA tensors, counted on
    ``ct_attention_cm.launches``; the plain version on CPU tensors."""
    _check(q_cm, k, v, base_cm, wz)
    if q_cm.dtype == BF16:
        return ct_attention_cm_bf16(q_cm, k, v, base_cm, wz)
    if _device("ct_attention_cm", q_cm) == "cpu":
        return ct_attention_reference_cm(q_cm, k, v, base_cm, wz)
    b, c, p = q_cm.shape
    out = torch.empty_like(base_cm)
    kernels.launch(ct_attention_cm, "ct_attention_cm",
                   (q_cm, k, v, base_cm, wz, out), (b, c, p, k.shape[1]))
    return out


def ct_attention_cm(
    q_cm: torch.Tensor,     # [B, C, P]
    k: torch.Tensor,        # [B, K, C]
    v: torch.Tensor,        # [B, K, C]
    base_cm: torch.Tensor,  # [B, C, P]
    wz: torch.Tensor,       # [C]
    flash: bool = True,
) -> torch.Tensor:
    """Class-major CT attention → [B, C, P] in q's type, differentiable
    in float32 and in bf16.

    With a gradient to take and ``flash`` it runs the stats forward, whose
    backward is the flash kernel; with ``flash=False`` (the reference's
    ``CT_ATTENTION_FLASH=0``) the eval forward, whose backward is the
    blockwise kernel. Without a gradient CUDA tensors go to the eval
    kernel, whose launches ``ct_attention_cm.launches`` counts, and CPU
    tensors to the plain version. bf16 inputs go to the bf16 kernels of
    the same roles (``ct_attention_cm_bf16`` and the ``*_bf16`` training
    kernels).
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q_cm, k, v, base_cm, wz)):
        fn = _CTAttentionCM if flash else _CTAttentionCMBlockwise
        return fn.apply(q_cm, k, v, base_cm, wz)
    return _cm_forward(q_cm, k, v, base_cm, wz)


ct_attention_cm.launches = 0


# --- the row-major layout: q, base, out [B, P, C] -------------------------

def ct_attention_reference(q, k, v, base, wz):
    """The plain row-major forward: materializes the [B, P, K] affinity."""
    s = torch.einsum("bpc,bkc->bpk", q, k)
    attn = torch.softmax(s, dim=-1)
    return base + torch.einsum("bpk,bkc->bpc", attn, v) * wz


def ct_attention_bwd_reference(q, k, v, wz, g):
    """The plain row-major blockwise backward → (dq [B,P,C], dk [B,K,C],
    dv [B,K,C], dwz [C]): the class-major one on the transposed q and g."""
    dq, dk, dv, dwz = ct_attention_cm_bwd_reference(
        q.transpose(1, 2), k, v, wz, g.transpose(1, 2))
    return dq.transpose(1, 2), dk, dv, dwz


def ct_attention_reference_bf16(q, k, v, base, wz, exp_bf16=False,
                                unfused=False):
    """The plain bf16 row-major forward (the JAX ``_kernel`` on bf16
    operands) → [B, P, C] bf16. With ``exp_bf16``, the bench's
    bfloat16-exponent variant, whose exponential's argument is rounded to
    bf16 too; with ``unfused``, the bench's unfused float32-exponent
    variant, which multiplies v by the weights rounded to bf16 but divides
    by the float32 sum of the weights before their rounding."""
    # one [B, K, P] buffer at a time where it can (B=128 at 300: 11 GB each)
    x = torch.einsum("bkc,bpc->bkp", k.float(), q.float())
    x = x - x.amax(dim=1, keepdim=True)
    if exp_bf16:
        x = x.to(BF16).float()
    x = torch.exp(x)
    e = x.to(BF16).float()
    den = (x if unfused else e).sum(dim=1)
    del x
    delta = torch.einsum("bkp,bkc->bpc", e, v.float()) / den[..., None]
    return (base.float() + delta * wz).to(BF16)


def ct_attention_bf16(q, k, v, base, wz) -> torch.Tensor:
    """The bf16 row-major forward → [B, P, C] bf16. CUDA
    tensors go to the kernel, counted on ``ct_attention_bf16.launches``;
    CPU tensors to the plain version."""
    _check(q, k, v, base, wz, "ct_attention_bf16", row_major=True)
    if _device("ct_attention_bf16", q) == "cpu":
        return ct_attention_reference_bf16(q, k, v, base, wz)
    return _launch_bf16(ct_attention_bf16, q, k, v, base, wz, True)


ct_attention_bf16.launches = 0


def _rm_forward(q, k, v, base, wz):
    """The row-major forward: the kernel on CUDA tensors, counted on
    ``ct_attention.launches``; the plain version on CPU tensors."""
    _check(q, k, v, base, wz, "ct_attention", row_major=True)
    if q.dtype == BF16:
        return ct_attention_bf16(q, k, v, base, wz)
    if _device("ct_attention", q) == "cpu":
        return ct_attention_reference(q, k, v, base, wz)
    b, p, c = q.shape
    out = torch.empty_like(base)
    kernels.launch(ct_attention, "ct_attention", (q, k, v, base, wz, out),
                   (b, c, p, k.shape[1]))
    return out


def ct_attention_bwd(q, k, v, wz, g):
    """Row-major blockwise backward → (dq [B,P,C], dk [B,K,C], dv [B,K,C],
    dwz [C]): the port of ``_bwd_kernel`` and ``ct_attention_bwd_pallas``
    in one kernel, with no transposes; the kernel on CUDA tensors, else the
    plain version. bf16 inputs go to ``ct_attention_bwd_bf16``."""
    _check(q, k, v, g, wz, "ct_attention_bwd", row_major=True)
    if q.dtype == BF16:
        return ct_attention_bwd_bf16(q, k, v, wz, g)
    if _device("ct_attention_bwd", q) == "cpu":
        return ct_attention_bwd_reference(q, k, v, wz, g)
    return _blockwise_bwd(ct_attention_bwd, q, k, v, wz, g, True)


ct_attention_bwd.launches = 0


class _CTAttention(torch.autograd.Function):
    """``ct_attention`` with its blockwise backward (the JAX package's
    ``_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, base, wz):
        ctx.save_for_backward(q, k, v, wz)
        return _rm_forward(q, k, v, base, wz)

    @staticmethod
    def backward(ctx, g):
        q, k, v, wz = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv, dwz = ct_attention_bwd(q, k, v, wz, g)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), g, dwz


def ct_attention(
    q: torch.Tensor,     # [B, P, C]
    k: torch.Tensor,     # [B, K, C]
    v: torch.Tensor,     # [B, K, C]
    base: torch.Tensor,  # [B, P, C]
    wz: torch.Tensor,    # [C]
) -> torch.Tensor:
    """Row-major CT attention → [B, P, C] in q's type, differentiable:
    ``base + softmax(q·kᵀ)·v·wz``. CUDA tensors go to the forward kernel,
    whose launches ``ct_attention.launches`` counts, and the gradient to the
    row-major backward kernel; CPU tensors to the plain versions. bf16
    inputs go to ``ct_attention_bf16`` and ``ct_attention_bwd_bf16``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, base, wz)):
        return _CTAttention.apply(q, k, v, base, wz)
    return _rm_forward(q, k, v, base, wz)


ct_attention.launches = 0


def ct_attention_variant_reference(q, k, v, base, wz):
    """The plain row-major forward with the exponential of (s - max s) as a
    bfloat16 exp computes it: argument and result rounded to bfloat16."""
    s = torch.einsum("bpc,bkc->bpk", q, k)
    x = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(x.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    delta = torch.einsum("bpk,bkc->bpc", e, v) / e.sum(dim=-1, keepdim=True)
    return base + delta * wz


def ct_attention_variant(q, k, v, base, wz) -> torch.Tensor:
    """The row-major forward kernel with its exponential rounded as a
    bfloat16 one, for the attention bench's bfloat16 variant (its float32
    variant is ``ct_attention``); forward only. CUDA tensors go to the
    kernel, whose launches ``ct_attention_variant.launches`` counts; CPU
    tensors to the plain version."""
    _check(q, k, v, base, wz, "ct_attention_variant", row_major=True)
    if q.dtype == BF16:
        return ct_attention_variant_bf16(q, k, v, base, wz)
    if _device("ct_attention_variant", q) == "cpu":
        return ct_attention_variant_reference(q, k, v, base, wz)
    b, p, c = q.shape
    out = torch.empty_like(base)
    kernels.launch(ct_attention_variant, "ct_attention_variant",
                   (q, k, v, base, wz, out), (b, c, p, k.shape[1]))
    return out


ct_attention_variant.launches = 0


def ct_attention_variant_bf16(q, k, v, base, wz) -> torch.Tensor:
    """The bench's bfloat16-exponent variant on bf16 inputs → [B, P, C]
    bf16: the bf16 row-major forward with the exponential's argument
    rounded to bf16 too, as ``make_variant(jnp.bfloat16, ...)`` computes
    on the JAX bench's bf16 inputs. CUDA tensors go to the kernel, counted
    on ``ct_attention_variant_bf16.launches``; CPU tensors to the plain
    version."""
    _check(q, k, v, base, wz, "ct_attention_variant_bf16", row_major=True)
    if _device("ct_attention_variant_bf16", q) == "cpu":
        return ct_attention_reference_bf16(q, k, v, base, wz, exp_bf16=True)
    return _launch_bf16(ct_attention_variant_bf16, q, k, v, base, wz, True)


ct_attention_variant_bf16.launches = 0


def ct_attention_variant_unfused_bf16(q, k, v, base, wz) -> torch.Tensor:
    """The bench's unfused float32-exponent variant on bf16 inputs →
    [B, P, C] bf16: as ``make_variant(jnp.float32, ..., fuse_denom=False)``
    computes on the JAX bench's bf16 inputs, v is multiplied by the weights
    e = exp(s − max s) rounded to bf16 and the sum divided by Σ e of the
    float32 weights before that rounding (the fused form and
    ``ct_attention_bf16`` divide by the sum of the rounded ones). Forward
    only, bf16 only. CUDA tensors go to the kernel, counted on
    ``ct_attention_variant_unfused_bf16.launches``; CPU tensors to the
    plain version."""
    _check(q, k, v, base, wz, "ct_attention_variant_unfused_bf16",
           row_major=True)
    _bf16_only("ct_attention_variant_unfused_bf16", q)
    if _device("ct_attention_variant_unfused_bf16", q) == "cpu":
        return ct_attention_reference_bf16(q, k, v, base, wz, unfused=True)
    return _launch_bf16(ct_attention_variant_unfused_bf16, q, k, v, base, wz,
                        True)


ct_attention_variant_unfused_bf16.launches = 0


MAX_NOVEL = 64     # the serving kernel's widest classifier


def ct_attention_serving_reference(
    conf_cm: torch.Tensor,     # [B, C, P] pre-CT logits
    k: torch.Tensor,           # [B, K, C] φ(keys) + keys
    v: torch.Tensor,           # [B, K, C] g(keys) + keys
    w_theta: torch.Tensor,     # [C, C] θ kernel, (in, out)
    b_theta: torch.Tensor,     # [C]
    wz: torch.Tensor,          # [C]
    obj_target: torch.Tensor,  # [N, C] class prototypes
    scale: float = 5.0,
) -> torch.Tensor:
    """The plain serving head → [B, N, P]: materializes q, the [B, K, P]
    affinity and novel."""
    q = (torch.einsum("co,bcp->bop", w_theta, conf_cm)
         + b_theta[None, :, None] + conf_cm)
    attn = torch.softmax(torch.einsum("bkc,bcp->bkp", k, q), dim=1)
    delta = torch.einsum("bkp,bkc->bcp", attn, v)
    novel = conf_cm + delta * wz[None, :, None]
    novel = novel * torch.rsqrt((novel * novel).sum(dim=1, keepdim=True))
    return torch.einsum("nc,bcp->bnp", obj_target, novel) * scale


def ct_attention_serving_reference_bf16(conf_cm, k, v, w_theta, b_theta, wz,
                                        obj_target, scale: float = 5.0):
    """The plain bf16 serving head (the JAX ``_serving_kernel`` on bf16
    conf, k, v, Wθ and OBJ_Target, f32 bθ and wz) → [B, N, P] bf16: q and
    the normalised novel rounded to bf16 where JAX rounds them, the
    attention as ``ct_attention_cm_bf16``'s."""
    conf = conf_cm.float()
    q = (torch.einsum("co,bcp->bop", w_theta.float(), conf)
         + b_theta[None, :, None] + conf).to(BF16)
    s = torch.einsum("bkc,bcp->bkp", k.float(), q.float())
    novel = conf + _weighted_bf16(s, v) * wz[None, :, None]
    novel = (novel * torch.rsqrt((novel * novel).sum(dim=1, keepdim=True))
             ).to(BF16)
    return (torch.einsum("nc,bcp->bnp", obj_target.float(), novel.float())
            * scale).to(BF16)


def ct_attention_serving_bf16(conf_cm, k, v, w_theta, b_theta, wz,
                              obj_target, scale: float = 5.0) -> torch.Tensor:
    """The bf16 serving head → [B, N, P] bf16, forward only. CUDA tensors
    go to the kernel, counted on ``ct_attention_serving_bf16.launches``;
    CPU tensors to the plain version."""
    _check_serving(conf_cm, k, v, w_theta, b_theta, wz, obj_target,
                   "ct_attention_serving_bf16")
    if conf_cm.dtype != BF16:
        raise TypeError(f"ct_attention_serving_bf16: conf is {conf_cm.dtype}")
    if _device("ct_attention_serving_bf16", conf_cm) == "cpu":
        return ct_attention_serving_reference_bf16(
            conf_cm, k, v, w_theta, b_theta, wz, obj_target, scale)
    b, c, p = conf_cm.shape
    kk, n = k.shape[1], obj_target.shape[0]
    out = conf_cm.new_empty((b, n, p))
    kernels.launch(ct_attention_serving_bf16, "ct_attention_serving_bf16",
                   (conf_cm, k, v, w_theta, b_theta, wz, obj_target, out,
                    _kv_scratch_bf16(conf_cm, b, c, kk)),
                   (b, c, p, kk, n, scale))
    return out


ct_attention_serving_bf16.launches = 0


def _check_serving(conf_cm, k, v, w_theta, b_theta, wz, obj_target, fn):
    """``_check`` of the attention's operands, then Wθ [C, C] and
    OBJ_Target [N, C] in conf's type and bθ [C] float32, N at most 64."""
    _check(conf_cm, k, v, conf_cm, wz, fn)
    c = conf_cm.shape[1]
    n = obj_target.shape[0]
    dt = conf_cm.dtype
    for name, t, shape, want in (("w_theta", w_theta, (c, c), dt),
                                 ("b_theta", b_theta, (c,), torch.float32),
                                 ("obj_target", obj_target, (n, c), dt)):
        if (tuple(t.shape) != shape or t.dtype != want
                or t.device != conf_cm.device):
            raise ValueError(f"{fn}: {name} must be {want} {list(shape)} on "
                             f"{conf_cm.device}")
    if not 1 <= n <= MAX_NOVEL:
        raise ValueError(f"{fn}: N={n} classes, the kernel takes 1 to "
                         f"{MAX_NOVEL}")


def ct_attention_serving(conf_cm, k, v, w_theta, b_theta, wz, obj_target,
                         scale: float = 5.0) -> torch.Tensor:
    """Fused serving CT head → cosine-classifier scores [B, N, P] float32:

        q     = Wθᵀ·conf + bθ + conf
        novel = conf + softmax_K(kᵀq)·v·wz
        out   = scale · OBJ·(novel / ‖novel‖₂)

    CUDA tensors go to the kernel, whose launches
    ``ct_attention_serving.launches`` counts; CPU tensors to the plain
    version. bf16 conf goes to ``ct_attention_serving_bf16``."""
    if conf_cm.dtype == BF16:
        return ct_attention_serving_bf16(conf_cm, k, v, w_theta, b_theta, wz,
                                         obj_target, scale)
    _check_serving(conf_cm, k, v, w_theta, b_theta, wz, obj_target,
                   "ct_attention_serving")
    c = conf_cm.shape[1]
    n = obj_target.shape[0]
    if _device("ct_attention_serving", conf_cm) == "cpu":
        return ct_attention_serving_reference(conf_cm, k, v, w_theta,
                                              b_theta, wz, obj_target, scale)
    b, _, p = conf_cm.shape
    out = conf_cm.new_empty((b, n, p))
    kernels.launch(ct_attention_serving, "ct_attention_serving",
                   (conf_cm, k, v, w_theta, b_theta, wz, obj_target, out),
                   (b, c, p, k.shape[1], n, scale))
    return out


ct_attention_serving.launches = 0
