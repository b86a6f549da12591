"""Context-Transformer attention, class-major: CUDA kernels + plain versions.

The port of ``ct_attention_cm`` (with its flash custom VJP),
``ct_attention_cm_stats``, ``_bwd_call_cm_flash`` and
``ct_attention_reference_cm`` from ``ct_tpu/ops/ct_attention.py``. Per
image,

    out = base + softmax_K(kᵀ q) · v · wz

with q = θ(conf) + conf over all P anchors (11,620 at 300), k/v over the K
max-pooled context anchors (1,858 at 300) and C source classes (15 incre,
60 transfer). q, base and out are [B, C, P]; k and v are [B, K, C].

Three kernels, each behind a wrapper that launches it for CUDA tensors
and takes its plain PyTorch version for CPU tensors, and counts its
launches in ``<wrapper>.launches``:

* ``ct_attention_cm`` itself (``csrc/ct_attention_cm.cu``): the forward
  alone, for calls that need no gradient;
* ``ct_attention_cm_stats`` (same source): the training forward, which
  also returns delta = softmax·v, the row max m and the denominator z;
* ``ct_attention_cm_bwd_flash`` (``csrc/ct_attention_cm_bwd.cu``): dq, dk
  and dv from the saved m and z and the softmax-Jacobian term colsum.

``ct_attention_cm`` is the public entry: with no gradient to take it runs
the eval kernel; otherwise it goes through an autograd Function whose
forward is the stats kernel and whose backward is the flash kernel, on
the card and (through their plain versions) on the CPU alike.
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


def _check(q_cm, k, v, base_cm, wz):
    tensors = {"q_cm": q_cm, "k": k, "v": v, "base_cm": base_cm, "wz": wz}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"ct_attention_cm: {name} is {t.dtype}, "
                            "the kernel takes float32")
        if t.device != q_cm.device:
            raise ValueError(f"ct_attention_cm: {name} is on {t.device}, "
                             f"q_cm on {q_cm.device}")
    if q_cm.dim() != 3 or k.dim() != 3:
        raise ValueError("ct_attention_cm: q_cm must be [B, C, P] and k "
                         "[B, K, C]")
    b, c, p = q_cm.shape
    kk = k.shape[1]
    if (tuple(base_cm.shape) != (b, c, p) or tuple(k.shape) != (b, kk, c)
            or tuple(v.shape) != (b, kk, c) or tuple(wz.shape) != (c,)):
        raise ValueError(
            "ct_attention_cm: shapes disagree: q_cm "
            f"{tuple(q_cm.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"base_cm {tuple(base_cm.shape)}, wz {tuple(wz.shape)}")
    if min(b, c, p, kk) < 1:
        raise ValueError("ct_attention_cm: empty input")
    if c > MAX_CLASSES:
        raise ValueError(f"ct_attention_cm: C={c} exceeds the kernel's "
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


for _fn in (ct_attention_cm_stats, ct_attention_cm_bwd_flash):
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


def ct_attention_cm(
    q_cm: torch.Tensor,     # [B, C, P]
    k: torch.Tensor,        # [B, K, C]
    v: torch.Tensor,        # [B, K, C]
    base_cm: torch.Tensor,  # [B, C, P]
    wz: torch.Tensor,       # [C]
) -> torch.Tensor:
    """Class-major CT attention → [B, C, P] float32, differentiable.

    With a gradient to take it runs the stats forward, whose backward is
    the flash kernel. Otherwise CUDA tensors go to the eval kernel, whose
    launches ``ct_attention_cm.launches`` counts, and CPU tensors to the
    plain version.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q_cm, k, v, base_cm, wz)):
        return _CTAttentionCM.apply(q_cm, k, v, base_cm, wz)
    _check(q_cm, k, v, base_cm, wz)
    if _device("ct_attention_cm", q_cm) == "cpu":
        return ct_attention_reference_cm(q_cm, k, v, base_cm, wz)
    b, c, p = q_cm.shape
    out = torch.empty_like(base_cm)
    kernels.launch(ct_attention_cm, "ct_attention_cm",
                   (q_cm, k, v, base_cm, wz, out), (b, c, p, k.shape[1]))
    return out


ct_attention_cm.launches = 0
