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
"""

from __future__ import annotations

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


def _check(q, k, v, base, wz, fn: str = "ct_attention_cm",
           row_major: bool = False):
    """Raise on what the kernels do not take: q and base [B, C, P] (or
    [B, P, C] with ``row_major``), k and v [B, K, C], wz [C], float32 on
    one device, C at most 64."""
    names = (("q", "k", "v", "base", "wz") if row_major
             else ("q_cm", "k", "v", "base_cm", "wz"))
    for name, t in zip(names, (q, k, v, base, wz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, "
                            "the kernel takes float32")
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
    if c > MAX_CLASSES:
        raise ValueError(f"{fn}: C={c} exceeds the kernel's "
                         f"{MAX_CLASSES} classes")


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
    version."""
    _check(q_cm, k, v, base_cm, wz)
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
    all [B,1,P]; the kernel on CUDA tensors, else the plain version."""
    _check(q_cm, k, v, g_cm, wz)
    b, c, p = q_cm.shape
    for name, t in (("m", m), ("z", z), ("colsum", colsum)):
        if (tuple(t.shape) != (b, 1, p) or t.dtype != torch.float32
                or t.device != q_cm.device):
            raise ValueError(f"ct_attention_cm_bwd_flash: {name} must be "
                             f"float32 [{b}, 1, {p}] on {q_cm.device}")
    if _device("ct_attention_cm_bwd_flash", q_cm) == "cpu":
        return ct_attention_cm_bwd_flash_reference(q_cm, k, v, wz, g_cm, m,
                                                   z, colsum)
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
    plain version."""
    _check(q_cm, k, v, g_cm, wz, "ct_attention_cm_bwd")
    if _device("ct_attention_cm_bwd", q_cm) == "cpu":
        return ct_attention_cm_bwd_reference(q_cm, k, v, wz, g_cm)
    return _blockwise_bwd(ct_attention_cm_bwd, q_cm, k, v, wz, g_cm, False)


for _fn in (ct_attention_cm_stats, ct_attention_cm_bwd_flash,
            ct_attention_cm_bwd):
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
        # the JAX package computes them outside its kernel
        gd = g_cm * delta
        dwz = gd.sum(dim=(0, 2))
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        dq, dk, dv = ct_attention_cm_bwd_flash(q_cm, k, v, wz, g_cm, m, z,
                                               colsum)
        # d/d(base) of base + delta·wz is the upstream gradient itself
        return dq, dk, dv, g_cm, dwz


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
        return dq, dk, dv, g_cm, dwz


def _cm_forward(q_cm, k, v, base_cm, wz):
    """The eval forward: the kernel on CUDA tensors, counted on
    ``ct_attention_cm.launches``; the plain version on CPU tensors."""
    _check(q_cm, k, v, base_cm, wz)
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
    """Class-major CT attention → [B, C, P] float32, differentiable.

    With a gradient to take and ``flash`` it runs the stats forward, whose
    backward is the flash kernel; with ``flash=False`` (the reference's
    ``CT_ATTENTION_FLASH=0``) the eval forward, whose backward is the
    blockwise kernel. Without a gradient CUDA tensors go to the eval
    kernel, whose launches ``ct_attention_cm.launches`` counts, and CPU
    tensors to the plain version.
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


def _rm_forward(q, k, v, base, wz):
    """The row-major forward: the kernel on CUDA tensors, counted on
    ``ct_attention.launches``; the plain version on CPU tensors."""
    _check(q, k, v, base, wz, "ct_attention", row_major=True)
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
    plain version."""
    _check(q, k, v, g, wz, "ct_attention_bwd", row_major=True)
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
        return dq, dk, dv, g, dwz


def ct_attention(
    q: torch.Tensor,     # [B, P, C]
    k: torch.Tensor,     # [B, K, C]
    v: torch.Tensor,     # [B, K, C]
    base: torch.Tensor,  # [B, P, C]
    wz: torch.Tensor,    # [C]
) -> torch.Tensor:
    """Row-major CT attention → [B, P, C] float32, differentiable:
    ``base + softmax(q·kᵀ)·v·wz``. CUDA tensors go to the forward kernel,
    whose launches ``ct_attention.launches`` counts, and the gradient to the
    row-major backward kernel; CPU tensors to the plain versions."""
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
    if _device("ct_attention_variant", q) == "cpu":
        return ct_attention_variant_reference(q, k, v, base, wz)
    b, p, c = q.shape
    out = torch.empty_like(base)
    kernels.launch(ct_attention_variant, "ct_attention_variant",
                   (q, k, v, base, wz, out), (b, c, p, k.shape[1]))
    return out


ct_attention_variant.launches = 0


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


def ct_attention_serving(conf_cm, k, v, w_theta, b_theta, wz, obj_target,
                         scale: float = 5.0) -> torch.Tensor:
    """Fused serving CT head → cosine-classifier scores [B, N, P] float32:

        q     = Wθᵀ·conf + bθ + conf
        novel = conf + softmax_K(kᵀq)·v·wz
        out   = scale · OBJ·(novel / ‖novel‖₂)

    CUDA tensors go to the kernel, whose launches
    ``ct_attention_serving.launches`` counts; CPU tensors to the plain
    version."""
    _check(conf_cm, k, v, conf_cm, wz, "ct_attention_serving")
    c = conf_cm.shape[1]
    n = obj_target.shape[0]
    for name, t, shape in (("w_theta", w_theta, (c, c)),
                           ("b_theta", b_theta, (c,)),
                           ("obj_target", obj_target, (n, c))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != conf_cm.device):
            raise ValueError(f"ct_attention_serving: {name} must be float32 "
                             f"{list(shape)} on {conf_cm.device}")
    if not 1 <= n <= MAX_NOVEL:
        raise ValueError(f"ct_attention_serving: N={n} classes, the kernel "
                         f"takes 1 to {MAX_NOVEL}")
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
