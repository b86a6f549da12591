"""Context-Transformer attention, class-major: CUDA kernel + plain version.

The port of ``ct_attention_cm`` and ``ct_attention_reference_cm`` from
``ct_tpu/ops/ct_attention.py``. Per image,

    out = base + softmax_K(kᵀ q) · v · wz

with q = θ(conf) + conf over all P anchors (11,620 at 300), k/v over the K
max-pooled context anchors (1,858 at 300) and C source classes (15 incre,
60 transfer). q, base and out are [B, C, P]; k and v are [B, K, C].

``ct_attention_cm`` launches the hand-written CUDA kernel
(``csrc/ct_attention_cm.cu``) for CUDA tensors and takes the plain version
for CPU tensors. It is the forward only: the training backward is still
to be ported, so a CUDA call that would need a gradient raises.
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


def ct_attention_cm(
    q_cm: torch.Tensor,     # [B, C, P]
    k: torch.Tensor,        # [B, K, C]
    v: torch.Tensor,        # [B, K, C]
    base_cm: torch.Tensor,  # [B, C, P]
    wz: torch.Tensor,       # [C]
) -> torch.Tensor:
    """Class-major CT attention forward → [B, C, P] float32.

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    ``ct_attention_cm.launches`` counts the kernel's launches.
    """
    _check(q_cm, k, v, base_cm, wz)
    if q_cm.device.type == "cpu":
        return ct_attention_reference_cm(q_cm, k, v, base_cm, wz)
    if q_cm.device.type != "cuda":
        raise ValueError(f"ct_attention_cm: no kernel for {q_cm.device}")
    for name, t in (("q_cm", q_cm), ("k", k), ("v", v), ("base_cm", base_cm),
                    ("wz", wz)):
        if not t.is_contiguous():
            raise ValueError(f"ct_attention_cm: {name} is not contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q_cm, k, v, base_cm, wz)):
        raise NotImplementedError(
            "ct_attention_cm: the CUDA backward is not ported yet; call it "
            "under torch.no_grad() or torch.inference_mode()")
    b, c, p = q_cm.shape
    kk = k.shape[1]
    fn = kernels.entry("ct_attention_cm")
    with torch.cuda.device(q_cm.device):
        out = torch.empty_like(base_cm)
        stream = torch.cuda.current_stream(q_cm.device).cuda_stream
        rc = fn(q_cm.data_ptr(), k.data_ptr(), v.data_ptr(),
                base_cm.data_ptr(), wz.data_ptr(), out.data_ptr(),
                b, c, p, kk, stream)
    if rc != 0:
        raise RuntimeError(f"ct_attention_cm: kernel launch failed with "
                           f"CUDA error {rc}")
    ct_attention_cm.launches += 1
    return out


ct_attention_cm.launches = 0
