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

Training (K7b). :func:`flash_attention` called with grad enabled on an
input that needs one goes through :class:`FlashAttention`: its forward is
the same launch asked also for the row log-sum-exp, and its backward is
K7b (:func:`flash_attention_backward`), with
:func:`flash_attention_backward_plain` for CPU tensors. K7b has two bodies
too, picked by :func:`backward_body_for`, a rule of the same kind:

  * ``csrc/flash_attention_bwd_tc.cu`` (:data:`TENSOR_CORES`): bfloat16
    q, k, v, o and dO with ``D % 8 == 0``, ``D <= 128`` and every pointer
    and (B, H, S) stride a multiple of 16 bytes — a Δ pass, then a dQ and
    a dK/dV kernel whose five products are bf16 ``wgmma`` fed by TMA;
  * ``csrc/flash_attention_bwd.cu`` (:data:`CUDA_CORES`): everything else
    (float32, head dims past 128 or off the multiple of 8, unaligned
    views), in float32 FMAs.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) nothing is
computed: K7 and K7b are the operators ``repro_torch::flash_attention_meta``
and ``repro_torch::flash_attention_bwd_meta``, whose fake implementations
return the tensors the launches allocate (o and the log-sum-exp; dq, dk, dv
and the Δ rows) and whose FLOP formulas (``torch.utils.flop_counter``) are
the kernels' own: 4·D a (query, key) pair for K7 and 10·D for K7b, over the
tiles the body that :func:`body_for` / :func:`backward_body_for` picks
computes (a causal tile wholly above the diagonal is skipped). No launch is
counted.

The log-sum-exp
contract, kept by both bodies and the plain version: a float32
``(B, Hq, Sq)`` tensor, ``lse[b, h, i] = log sum_j exp(q_i . k_j / sqrt(D))``
in natural log over the keys row i sees (float64 from the plain version
for float64 inputs). Without a gradient (serving) the kernels get a null
pointer and write none.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches):
#: every K7 launch, and those of them that ran the tensor-core body; every
#: K7b call, and those of them that ran its tensor-core body
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_tc": 0}
#: the two CUDA bodies, as :func:`body_for` and :func:`backward_body_for`
#: name them
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
#: KV chunk of the plain version (the reference's default)
PLAIN_CHUNK = 512
#: widest head the kernel takes (its tiles fill the shared memory there)
MAX_HEAD_DIM = 256
#: widest head the backward takes (its four float32 tiles and the score
#: tile fill the 227 KB of shared memory there); every config's is <= 160
MAX_BWD_HEAD_DIM = 192
#: widest head the backward's tensor-core body takes: a dK/dV consumer
#: keeps two 64 x 128 float32 accumulators and the 64 x 64 scores in its
#: registers (234 of 255 at 128; stablelm-12b's 160 stays on the CUDA cores)
MAX_BWD_TC_HEAD_DIM = 128
#: the backward's tensor-core scratch rows (lse and Δ) pad Sq to this
BWD_ROW_PAD = 64
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


def _acc_dtype(q) -> torch.dtype:
    """The plain versions' arithmetic: float32, or float64 for float64."""
    return torch.promote_types(q.dtype, torch.float32)


def flash_attention_plain(q, k, v, causal: bool = True, chunk: int = PLAIN_CHUNK,
                          return_lse: bool = False):
    """The kernel's function in PyTorch: KV chunks of ``chunk`` with an
    online softmax (``_flash_ref_chunked``), in float32 (float64 inputs,
    which only the plain versions take, stay float64). With ``return_lse``
    it returns ``(o, lse)``, lse the (B, Hq, Sq) row log-sum-exp in natural
    log (the module's contract)."""
    b, h, sq, d = q.shape
    k, v = gqa_broadcast(k, h), gqa_broadcast(v, h)
    sk = k.shape[2]
    chunk = min(chunk, sk)
    nk = -(-sk // chunk)
    padded = nk * chunk != sk
    if padded:  # ragged tail: pad KV to whole chunks, mask below
        pad = (0, 0, 0, nk * chunk - sk)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    ad = _acc_dtype(q)
    qf = q.to(ad) * (1.0 / (d ** 0.5))
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    acc = torch.zeros((b, h, sq, d), dtype=ad, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), dtype=ad, device=q.device)
    l = torch.zeros((b, h, sq), dtype=ad, device=q.device)
    for i in range(nk):
        k0 = i * chunk
        kc = k[:, :, k0:k0 + chunk].to(ad)
        vc = v[:, :, k0:k0 + chunk].to(ad)
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
    o = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return (o, m + torch.log(l)) if return_lse else o


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool = True,
                                   chunk: int = PLAIN_CHUNK):
    """K7b's function in PyTorch: (dq, dk, dv) of attention at q, k, v
    given its output ``o``, its log-sum-exp ``lse`` and the output's
    gradient ``do``. Over KV chunks of ``chunk``: P = exp(S/sqrt(D) - lse)
    recomputed, Δ = rowsum(dO ∘ O), dS = P ∘ (dO Vᵀ - Δ), dQ = dS K /
    sqrt(D), dK = dSᵀ Q / sqrt(D), dV = Pᵀ dO; a kv head's dK and dV summed
    over its group of query heads. Float32 arithmetic (float64 for float64
    inputs), the gradients in the inputs' dtypes."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / (d ** 0.5)
    ad = _acc_dtype(q)
    kf, vf = gqa_broadcast(k, h).to(ad), gqa_broadcast(v, h).to(ad)
    qf, dof = q.to(ad), do.to(ad)
    delta = (dof * o.to(ad)).sum(dim=-1)
    dq = torch.zeros((b, h, sq, d), dtype=ad, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=ad, device=q.device)
    dv = torch.zeros((b, h, sk, d), dtype=ad, device=q.device)
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    for k0 in range(0, sk, chunk):
        kc, vc = kf[:, :, k0:k0 + chunk], vf[:, :, k0:k0 + chunk]
        p = torch.exp((qf @ kc.transpose(-1, -2)) * scale - lse[..., None])
        if causal:
            k_pos = k0 + torch.arange(kc.shape[2], device=q.device)
            p = torch.where(q_pos[:, None] >= k_pos[None, :], p, 0.0)
        dv[:, :, k0:k0 + chunk] = p.transpose(-1, -2) @ dof
        ds = p * (dof @ vc.transpose(-1, -2) - delta[..., None])
        dq += (ds @ kc) * scale
        dk[:, :, k0:k0 + chunk] = (ds.transpose(-1, -2) @ qf) * scale
    dk = dk.reshape(b, hkv, g, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, g, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tma_ready(tensors, max_d: int) -> bool:
    """bfloat16 (B, H, S, D) tensors that the tensor-core bodies' TMA maps
    address: ``D % 8 == 0``, ``D <= max_d``, a unit-stride head dim, every
    data pointer and every stride of the B, H and S dims a multiple of 16
    bytes."""
    d = tensors[0].shape[-1]
    return (d % 8 == 0 and d <= max_d
            and all(t.dtype == torch.bfloat16 and t.stride(3) == 1
                    and t.data_ptr() % 16 == 0
                    and all(t.stride(i) * t.element_size() % 16 == 0 for i in range(3))
                    for t in tensors))


def body_for(q, k, v) -> str:
    """The CUDA body that K7 launches for (B, H, S, D) inputs q, k, v that
    its checks accept: :data:`TENSOR_CORES` for bfloat16 with ``D % 8 ==
    0`` and every data pointer and every stride of the B, H and S dims a
    multiple of 16 bytes (TMA's alignment); :data:`CUDA_CORES` otherwise.
    Pure: reads dtypes, shapes, strides and pointers only, on any device."""
    return TENSOR_CORES if _tma_ready((q, k, v), MAX_HEAD_DIM) else CUDA_CORES


def backward_body_for(q, k, v, o, do) -> str:
    """The CUDA body that K7b launches for q, k, v, the forward's o and the
    output's gradient do: :data:`TENSOR_CORES` where all five are bfloat16
    that TMA can address (as :func:`body_for`) with ``D <=``
    :data:`MAX_BWD_TC_HEAD_DIM`; :data:`CUDA_CORES` otherwise. Pure, like
    :func:`body_for`."""
    return (TENSOR_CORES if _tma_ready((q, k, v, o, do), MAX_BWD_TC_HEAD_DIM)
            else CUDA_CORES)


def _check_qkv(name: str, q, k, v, max_d: int) -> None:
    """The checks K7 and K7b share: 4-D GQA q, k, v of one dtype and
    device, head dim in 1..``max_d`` with unit stride."""
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
    if not 1 <= d <= max_d:
        raise ValueError(f"{name}: head dim {d} outside 1..{max_d}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must have unit stride")


def _strides(*tensors):
    """The (B, H, S) element strides of each tensor, as the C side reads
    them."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def _launch(q, k, v, causal: bool, body: str, with_lse: bool = False):
    """Launch ``body`` (:data:`TENSOR_CORES` or :data:`CUDA_CORES`) on
    CUDA tensors after the checks; :func:`flash_attention` passes
    :func:`body_for`'s choice. With ``with_lse`` the launch also writes the
    row log-sum-exp and ``(o, lse)`` is returned."""
    name = "flash_attention"
    _check_qkv(name, q, k, v, MAX_HEAD_DIM)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * hq * sq * d == 0:
        return (o, lse) if with_lse else o
    if sk == 0:
        raise ValueError(f"{name}: no keys")
    lib = "flash_attention_tc" if body == TENSOR_CORES else name
    fn = getattr(_build.load(lib), f"{lib}_launch")   # one C interface for both
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(),
                _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                ctypes.cast(_strides(q, k, v), ctypes.c_void_p),
                math.log2(math.e) / math.sqrt(d), int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib)
    _build.count(LAUNCHES, name)
    if lib != name:
        _build.count(LAUNCHES, lib)
    return (o, lse) if with_lse else o


def _launch_backward(q, k, v, o, lse, do, causal: bool, body: str | None = None):
    """Launch K7b's ``body`` (:data:`TENSOR_CORES`: a Δ pass, a dQ and a
    dK/dV kernel; :data:`CUDA_CORES`: a dQ pass, then a dK/dV pass; None:
    :func:`backward_body_for`'s choice) on CUDA tensors after the checks.
    ``do`` is read through its strides; only a head dim without unit stride
    is copied (contiguous) first."""
    name = "flash_attention_bwd"
    _check_qkv(name, q, k, v, MAX_BWD_HEAD_DIM)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or o.stride(3) != 1:
        raise ValueError(f"{name}: o and do must have q's dtype, o a unit-stride head dim")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous float32 (B, Hq, Sq) tensor")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError(f"{name}: every input must lie on q's device")
    if body is None:
        body = backward_body_for(q, k, v, o, do)
    if do.stride(3) != 1:
        do = do.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, hkv, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, hkv, sk, d), dtype=v.dtype, device=v.device)
    if b * hq * sq * d == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = "flash_attention_bwd_tc" if body == TENSOR_CORES else name
    # Δ (b, hq, sq), or the tensor-core body's rows of lse·log2(e) and Δ
    rows = ((2, b, hq, -(-sq // BWD_ROW_PAD) * BWD_ROW_PAD) if body == TENSOR_CORES
            else (b, hq, sq))
    delta = torch.empty(rows, dtype=torch.float32, device=q.device)
    fn = getattr(_build.load(lib), f"{lib}_launch")   # one C interface for both
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                ctypes.cast(_strides(q, k, v, o, do), ctypes.c_void_p),
                math.log2(math.e) / math.sqrt(d), 1.0 / math.sqrt(d), int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib)
    _build.count(LAUNCHES, name)
    if lib != name:
        _build.count(LAUNCHES, lib)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# On meta: the launches' outputs and FLOPs, nothing computed
# ---------------------------------------------------------------------------
#: (query rows, keys) of a tile: K7's bodies, then K7b's (its query-major
#: pass: the tensor-core body's dQ kernel, the CUDA-core body's dQ pass)
FWD_TILES = {TENSOR_CORES: (128, 128), CUDA_CORES: (64, 64)}
FWD_TILES_WIDE = (128, 64)   # the tensor-core body past D = 128
BWD_TILES = {TENSOR_CORES: (128, 64), CUDA_CORES: (64, 64)}


def tile_pairs(b: int, hq: int, sq: int, sk: int, tiles: tuple, causal: bool) -> int:
    """(query, key) pairs in the tiles a launch computes: each query tile
    of ``tiles[0]`` rows takes whole key tiles of ``tiles[1]`` up to the
    last key its last row sees (all of them when not causal)."""
    bq, bk = tiles
    shift, total = sk - sq, 0
    for q0 in range(0, sq, bq):
        kend = min(sk, min(q0 + bq, sq) + shift) if causal else sk
        total += bq * (-(-max(kend, 0) // bk)) * bk
    return b * hq * total


def _fwd_tiles(q, k, v) -> tuple:
    body = body_for(q, k, v)
    return FWD_TILES_WIDE if body == TENSOR_CORES and q.shape[-1] > 128 else FWD_TILES[body]


@torch.library.custom_op("repro_torch::flash_attention_meta", mutates_args=())
def _flash_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    raise RuntimeError("flash_attention_meta computes nothing: it is for meta tensors")


@_flash_meta.register_fake
def _(q, k, v, causal, with_lse):
    b, hq, sq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, sq) if with_lse else (0,), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd_meta", mutates_args=())
def _flash_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, causal: bool
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    raise RuntimeError("flash_attention_bwd_meta computes nothing: it is for meta tensors")


@_flash_bwd_meta.register_fake
def _(q, k, v, o, lse, do, causal):
    b, hq, sq, _ = q.shape
    rows = ((2, b, hq, -(-sq // BWD_ROW_PAD) * BWD_ROW_PAD)
            if backward_body_for(q, k, v, o, do) == TENSOR_CORES else (b, hq, sq))
    return (q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape),
            q.new_empty(rows, dtype=torch.float32))


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention_meta, get_raw=True)
    def _(q, k, v, causal, with_lse, *args, **kwargs):
        b, hq, sq, d = q.shape
        return 4 * d * tile_pairs(b, hq, sq, k.shape[2], _fwd_tiles(q, k, v), causal)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd_meta, get_raw=True)
    def _(q, k, v, o, lse, do, causal, *args, **kwargs):
        b, hq, sq, d = q.shape
        return 10 * d * tile_pairs(b, hq, sq, k.shape[2],
                                   BWD_TILES[backward_body_for(q, k, v, o, do)], causal)


_register_flops()


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of K7 at q, k, v: K7b for CUDA tensors (the body
    :func:`backward_body_for` picks), the plain version for CPU ones."""
    if q.is_cuda:
        return _launch_backward(q, k, v, o, lse, do, causal)
    return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal)


class FlashAttention(torch.autograd.Function):
    """K7 with its gradient: the forward launch writes the log-sum-exp
    beside o, and the backward is K7b (on the CPU, the plain versions of
    both). q, k, v, o and the log-sum-exp are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            o, lse = _launch(q, k, v, causal, body_for(q, k, v), with_lse=True)
        elif q.is_meta:
            o, lse = torch.ops.repro_torch.flash_attention_meta(q, k, v, causal, True)
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_meta:
            dq, dk, dv, _ = torch.ops.repro_torch.flash_attention_bwd_meta(q, k, v, o, lse, do,
                                                                           ctx.causal)
        else:
            dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Attention of q over GQA k, v: the CUDA kernel for CUDA tensors, the
    plain version for CPU ones; differentiable through
    :class:`FlashAttention` when an input needs a gradient (one launch, no
    log-sum-exp, otherwise). A causal call with more queries than keys
    raises (a query row would see no key)."""
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"flash_attention: causal with Sq={q.shape[2]} > "
                         f"Sk={k.shape[2]} leaves query rows without keys")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if q.is_cuda:
        return _launch(q, k, v, causal, body_for(q, k, v))
    if q.is_meta:
        return torch.ops.repro_torch.flash_attention_meta(q, k, v, causal, False)[0]
    return flash_attention_plain(q, k, v, causal=causal)
