"""Causal flash attention: CUDA kernel (K7) and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``)
with the meaning of the reference's CPU path, ``ops._flash_ref_chunked``,
which equals ``ref.attention_ref``:

  * q ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Sk, D)``; query head ``h``
    reads kv head ``h // (Hq/Hkv)`` (``jnp.repeat``'s order), and
    ``Hq % Hkv != 0`` raises the reference's ``_gqa_broadcast`` error;
  * the causal mask is aligned at the end: query ``i`` sees keys
    ``j <= i + (Sk - Sq)``;
  * any S: a ragged tail is masked (the Pallas kernel raises unless S
    divides its blocks, and aligns its causal mask at the start, which
    agrees only when ``Sq == Sk``);
  * scale ``1/sqrt(D)`` as a Python float; float32 or bfloat16 in, float32
    accumulation, the output in q's dtype.

A CPU tensor goes through :func:`flash_attention_plain` (KV chunks of 512
with an online softmax, as ``_flash_ref_chunked``); a CUDA tensor launches
one of two bodies, one launch per call, reading the kv heads in place (no
repeat) through the strides of q, k and v. :func:`body_for` picks it by a
rule on dtype, head dim and alignment, never by trying:

  * ``csrc/flash_attention_tc.cu`` (:data:`TENSOR_CORES`): bfloat16 with
    ``D % 8 == 0`` and every pointer and (B, H, S) stride a multiple of 16
    bytes, as TMA requires — both products as bf16 ``wgmma`` with float32
    accumulators, K and V brought in by TMA;
  * ``csrc/flash_attention.cu`` (:data:`CUDA_CORES`): everything else
    (float32, odd head dims, unaligned views), all in float32 FMAs. Float32
    stays there, off TF32, to keep its 1e-4 bound.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches):
#: every K7 launch, and those of them that ran the tensor-core body
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}
#: the two CUDA bodies, as :func:`body_for` names them
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
#: KV chunk of the plain version (the reference's default)
PLAIN_CHUNK = 512
#: widest head the kernel takes (its tiles fill the shared memory there)
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_heads(hq: int, hkv: int) -> None:
    """The reference's ``_gqa_broadcast`` error on ``Hq % Hkv != 0``."""
    if hq % hkv != 0:
        # floor-division repeat would silently drop heads (Hkv=3, Hq=7 -> 6)
        raise ValueError(
            f"GQA requires the query head count to be a multiple of the kv "
            f"head count; got Hq={hq} query heads, Hkv={hkv} kv heads")


def gqa_broadcast(k, hq: int):
    """Repeat kv heads to ``hq`` query heads (``jnp.repeat`` on axis 1)."""
    check_heads(hq, k.shape[1])
    rep = hq // k.shape[1]
    return k.repeat_interleave(rep, dim=1) if rep > 1 else k


def flash_attention_plain(q, k, v, causal: bool = True, chunk: int = PLAIN_CHUNK):
    """The kernel's function in PyTorch: KV chunks of ``chunk`` with an
    online softmax (``_flash_ref_chunked``)."""
    b, h, sq, d = q.shape
    k, v = gqa_broadcast(k, h), gqa_broadcast(v, h)
    sk = k.shape[2]
    chunk = min(chunk, sk)
    nk = -(-sk // chunk)
    padded = nk * chunk != sk
    if padded:  # ragged tail: pad KV to whole chunks, mask below
        pad = (0, 0, 0, nk * chunk - sk)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    qf = q.float() * (1.0 / (d ** 0.5))
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(nk):
        k0 = i * chunk
        kc = k[:, :, k0:k0 + chunk].float()
        vc = v[:, :, k0:k0 + chunk].float()
        s = qf @ kc.transpose(-1, -2)
        if causal or padded:  # aligned non-causal stays mask-free
            k_pos = k0 + torch.arange(chunk, device=q.device)
            valid = k_pos[None, :] < sk        # padded tail keys drop out
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + p @ vc
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def body_for(q, k, v) -> str:
    """The CUDA body that K7 launches for (B, H, S, D) inputs q, k, v that
    its checks accept: :data:`TENSOR_CORES` for bfloat16 with ``D % 8 ==
    0`` and every data pointer and every stride of the B, H and S dims a
    multiple of 16 bytes (TMA's alignment); :data:`CUDA_CORES` otherwise.
    Pure: reads dtypes, shapes, strides and pointers only, on any device."""
    tensors = (q, k, v)
    aligned = all(t.data_ptr() % 16 == 0
                  and all(t.stride(i) * t.element_size() % 16 == 0 for i in range(3))
                  for t in tensors)
    if (all(t.dtype == torch.bfloat16 for t in tensors) and q.shape[-1] % 8 == 0
            and q.shape[-1] <= MAX_HEAD_DIM and aligned):
        return TENSOR_CORES
    return CUDA_CORES


def _launch(q, k, v, causal: bool, body: str):
    """Launch ``body`` (:data:`TENSOR_CORES` or :data:`CUDA_CORES`) on
    CUDA tensors after the checks; :func:`flash_attention` passes
    :func:`body_for`'s choice."""
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    check_heads(hq, hkv)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be float32 or bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must lie on one device")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} outside 1..{MAX_HEAD_DIM}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must have unit stride")
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if b * hq * sq * d == 0:
        return o
    if sk == 0:
        raise ValueError(f"{name}: no keys")
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    lib = "flash_attention_tc" if body == TENSOR_CORES else name
    fn = getattr(_build.load(lib), f"{lib}_launch")   # one C interface for both
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                ctypes.cast(strides, ctypes.c_void_p),
                math.log2(math.e) / math.sqrt(d), int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib)
    LAUNCHES[name] += 1
    if lib != name:
        LAUNCHES[lib] += 1
    return o


def flash_attention(q, k, v, causal: bool = True):
    """Attention of q over GQA k, v: the CUDA kernel for CUDA tensors, the
    plain version for CPU ones. A causal call with more queries than keys
    raises (a query row would see no key)."""
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"flash_attention: causal with Sq={q.shape[2]} > "
                         f"Sk={k.shape[2]} leaves query rows without keys")
    if q.is_cuda:
        return _launch(q, k, v, causal, body_for(q, k, v))
    return flash_attention_plain(q, k, v, causal=causal)
