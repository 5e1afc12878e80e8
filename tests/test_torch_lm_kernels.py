"""The plain versions of the LM kernels — flash attention (K7) and the gated
linear scan (K8) — against ``repro`` on the same inputs, made with numpy
from a seed (CPU).

K7's plain version ports ``ops._flash_ref_chunked``: float32 within 2e-5
of it and of ``ref.attention_ref`` (float32 sums in another order),
bfloat16 within 2e-2 (the output rounds to bfloat16), the tolerances of
``tests/test_kernels.py``. Against the interpreted Pallas kernel only
``Sq == Sk`` is compared: its causal mask is aligned at the start.

K8's plain version rounds ``decay·h + x`` once (``core.semiring.fma_f32``),
as the CUDA kernel does (``__fmaf_rn``) and as XLA's CPU compiler contracts
the reference's ``d*h + x`` into one fused multiply-add: it equals the
jitted reference and the interpreted Pallas kernel bit for bit.

K7's body rule (:func:`flash_attention.body_for`), which picks the CUDA
body for a card's tensors, is pure and is checked here on CPU tensors; so
is K7b's (:func:`flash_attention.backward_body_for`), which reads q, k, v,
the forward's o and the output's gradient dO.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chunked_scan import chunked_scan_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.core.semiring import fma_f32  # noqa: E402
from repro_torch.kernels import chunked_scan as k8  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 2e-2


def _tol(dtype) -> float:
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,d,bq,bk", [(128, 64, 64, 64), (256, 32, 128, 128),
                                       (128, 128, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_against_pallas_interpret(s, d, bq, bk, causal, dtype):
    rng = np.random.default_rng(s + d + bq)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(3, s, d)), dtype)
                                    for _ in range(3))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                  interpret=True)
    got = k7.flash_attention_plain(tq[None], tk[None], tv[None], causal=causal)[0]
    assert got.dtype == tq.dtype
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("s", [5, 7, 130])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_against_chunked_reference_and_oracle(s, hq, hkv, causal, dtype):
    """Ragged S (no whole chunk or tile), MHA, GQA and MQA: the port's
    ``ops.flash_attention`` on the CPU against ``_flash_ref_chunked`` at
    its default chunk (after the reference's GQA broadcast) and against
    the exact-softmax oracle."""
    rng = np.random.default_rng(s * 10 + hq + hkv)
    jq, tq = _pair(rng.normal(size=(2, hq, s, 16)), dtype)
    jk, tk = _pair(rng.normal(size=(2, hkv, s, 16)), dtype)
    jv, tv = _pair(rng.normal(size=(2, hkv, s, 16)), dtype)
    jk, jv = jops._gqa_broadcast(jk, hq), jops._gqa_broadcast(jv, hq)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    _close(got, jops._flash_ref_chunked(jq, jk, jv, causal=causal), _tol(dtype))
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), _tol(dtype))


@pytest.mark.parametrize("sq,sk", [(3, 7), (1, 130), (64, 600)])
def test_k7_plain_end_aligned_causal_mask(sq, sk):
    """Fewer queries than keys: query i sees keys up to i + sk - sq, as in
    ``_flash_ref_chunked`` and both packages' oracles (600 keys span two
    chunks of the plain version)."""
    rng = np.random.default_rng(sq + sk)
    jq, tq = _pair(rng.normal(size=(1, 2, sq, 16)), "float32")
    jk, tk = _pair(rng.normal(size=(1, 2, sk, 16)), "float32")
    jv, tv = _pair(rng.normal(size=(1, 2, sk, 16)), "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True)
    _close(got, jops._flash_ref_chunked(jq, jk, jv, causal=True), F32_TOL)
    _close(got, jref.attention_ref(jq, jk, jv, causal=True), F32_TOL)
    _close(tref.attention_ref(tq, tk, tv, causal=True),
           jref.attention_ref(jq, jk, jv, causal=True), F32_TOL)


def test_k7_rejects_indivisible_heads_and_keyless_rows():
    k = torch.zeros((1, 3, 8, 4))
    with pytest.raises(ValueError, match=r"Hq=7.*Hkv=3"):
        ops.flash_attention(torch.zeros((1, 7, 8, 4)), k, k)
    with pytest.raises(ValueError, match=r"Hq=7.*Hkv=3"):
        jops._gqa_broadcast(jnp.zeros((1, 3, 8, 4)), 7)
    assert k7.gqa_broadcast(k, 6).shape == (1, 6, 8, 4)
    with pytest.raises(ValueError, match="without keys"):
        ops.flash_attention(torch.zeros((1, 3, 9, 4)), k, k, causal=True)


def test_k7_gqa_reads_kv_head_h_over_group():
    """Query head h attends with kv head h // (Hq/Hkv) (``jnp.repeat``)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 6, 9, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 9, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 9, 8)).astype(np.float32))
    got = ops.flash_attention(q, k, v)
    for h in range(6):
        want = tref.attention_ref(q[:, h:h + 1], k[:, h // 3:h // 3 + 1],
                                  v[:, h // 3:h // 3 + 1])
        torch.testing.assert_close(got[:, h:h + 1], want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("d", [16, 96, 100, 128, 160, 256])
@pytest.mark.parametrize("view", ["contiguous", "heads_major"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_body_rule(d, view, dtype):
    """The tensor-core body takes bfloat16 with D % 8 == 0 and 16-byte
    aligned pointers and strides, whether q, k, v are contiguous or the
    model's heads-major views of (B, S, H, D); every other input takes the
    float32 CUDA-core body."""
    def make(h):
        if view == "contiguous":
            return torch.zeros((2, h, 5, d), dtype=dtype)
        return torch.zeros((2, 5, h, d), dtype=dtype).transpose(1, 2)

    q, k, v = make(6), make(2), make(2)
    want = (k7.TENSOR_CORES if dtype == torch.bfloat16 and d % 8 == 0
            else k7.CUDA_CORES)
    assert k7.body_for(q, k, v) == want


@pytest.mark.parametrize("breaks", ["pointer", "s_stride", "h_stride", "kv_only"])
def test_k7_body_rule_unaligned_bf16_takes_cuda_cores(breaks):
    """A bfloat16 view that TMA cannot address (a pointer or a stride not a
    multiple of 16 bytes) takes the CUDA-core body."""
    d = 64
    aligned = torch.zeros((1, 4, 9, d), dtype=torch.bfloat16)
    if breaks == "pointer":       # offset by one element: 2 bytes
        t = torch.zeros(aligned.numel() + 1, dtype=torch.bfloat16)[1:].view(1, 4, 9, d)
        q = k = v = t
    elif breaks == "s_stride":    # rows of 68 elements: 136 bytes
        q = k = v = torch.zeros((1, 4, 9, 68), dtype=torch.bfloat16)[..., :d]
    elif breaks == "h_stride":    # heads 9 * 68 elements apart
        q = k = v = torch.zeros((1, 9, 4, 68), dtype=torch.bfloat16)[..., :d].transpose(1, 2)
    else:                         # q aligned, k and v sliced
        q = aligned
        k = v = torch.zeros((1, 4, 9, 68), dtype=torch.bfloat16)[..., :d]
    assert k7.body_for(aligned, aligned, aligned) == k7.TENSOR_CORES
    assert k7.body_for(q, k, v) == k7.CUDA_CORES


def _backward_inputs(d: int, dtype, view: str) -> list:
    """q, k, v, o and dO for K7b's rule: q, k, v and o contiguous or the
    model's heads-major views of (B, S, H, D); dO always the transposed
    view autograd hands the backward."""
    def make(h):
        if view == "contiguous":
            return torch.zeros((2, h, 5, d), dtype=dtype)
        return torch.zeros((2, 5, h, d), dtype=dtype).transpose(1, 2)

    return [make(6), make(2), make(2), make(6),
            torch.zeros((2, 5, 6, d), dtype=dtype).transpose(1, 2)]


@pytest.mark.parametrize("d", [8, 64, 96, 128])
@pytest.mark.parametrize("view", ["contiguous", "heads_major"])
def test_k7b_body_rule_takes_tensor_cores(d, view):
    """bfloat16 q, k, v, o and dO with D % 8 == 0, D <= 128 and 16-byte
    aligned pointers and strides take K7b's tensor-core body."""
    assert k7.backward_body_for(*_backward_inputs(d, torch.bfloat16, view)) == k7.TENSOR_CORES


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (96, torch.float32),
                                     (128, torch.float32), (100, torch.bfloat16),
                                     (36, torch.bfloat16), (136, torch.bfloat16),
                                     (160, torch.bfloat16), (192, torch.bfloat16)])
@pytest.mark.parametrize("view", ["contiguous", "heads_major"])
def test_k7b_body_rule_takes_cuda_cores(d, dtype, view):
    """float32, a head dim off the multiple of 8, and one past
    ``MAX_BWD_TC_HEAD_DIM`` (stablelm-12b's 160 among them) take K7b's
    CUDA-core body."""
    assert k7.MAX_BWD_TC_HEAD_DIM == 128
    assert k7.backward_body_for(*_backward_inputs(d, dtype, view)) == k7.CUDA_CORES


def _unaligned_like(t, breaks: str):
    """A bfloat16 tensor of ``t``'s (B, H, S, D) shape whose data pointer or
    B, H or S stride is not a multiple of 16 bytes (TMA refuses it)."""
    b, h, s, d = t.shape
    if breaks == "pointer":       # offset by one element: 2 bytes
        return torch.zeros(t.numel() + 1, dtype=torch.bfloat16)[1:].view(b, h, s, d)
    if breaks == "s_stride":      # rows of d + 4 elements
        return torch.zeros((b, h, s, d + 4), dtype=torch.bfloat16)[..., :d]
    if breaks == "h_stride":      # heads d + 4 elements apart
        return torch.zeros((b, s, h, d + 4), dtype=torch.bfloat16)[..., :d].transpose(1, 2)
    # batch entries h * s * d + 4 elements apart
    return torch.zeros((b, h * s * d + 4), dtype=torch.bfloat16)[:, :h * s * d].view(b, h, s, d)


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "do"])
@pytest.mark.parametrize("breaks", ["pointer", "s_stride", "h_stride", "b_stride"])
def test_k7b_body_rule_unaligned_bf16_takes_cuda_cores(which, breaks):
    """One bfloat16 input of the five that TMA cannot address (a pointer or
    a B, H or S stride not a multiple of 16 bytes) sends K7b to the
    CUDA-core body; the other four aligned."""
    inputs = _backward_inputs(64, torch.bfloat16, "heads_major")
    assert k7.backward_body_for(*inputs) == k7.TENSOR_CORES
    i = ["q", "k", "v", "o", "do"].index(which)
    inputs[i] = _unaligned_like(inputs[i], breaks)
    assert k7.backward_body_for(*inputs) == k7.CUDA_CORES


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------
def _scan_inputs(t: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, d)).astype(np.float32),
            rng.uniform(0.8, 1.0, size=(t, d)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


@pytest.mark.parametrize("t,d,chunk,bd", [(64, 32, 16, 32), (128, 64, 32, 32),
                                          (256, 16, 128, 16)])
def test_k8_plain_against_pallas_interpret_and_oracle(t, d, chunk, bd):
    x, dec, h0 = _scan_inputs(t, d, t + d)
    jx, jdec, jh0 = (jnp.asarray(a) for a in (x, dec, h0))
    got_all, got_last = ops.linear_scan(torch.from_numpy(x), torch.from_numpy(dec),
                                        torch.from_numpy(h0), chunk=chunk)
    for want_all, want_last in (
            chunked_scan_pallas(jx, jdec, jh0, chunk=chunk, bd=bd, interpret=True),
            jax.jit(jref.chunked_scan_ref)(jx, jdec, jh0)):
        assert np.array_equal(got_all.numpy(), np.asarray(want_all))
        assert np.array_equal(got_last.numpy(), np.asarray(want_last))
    oracle_all, oracle_last = tref.chunked_scan_ref(
        torch.from_numpy(x), torch.from_numpy(dec), torch.from_numpy(h0))
    assert torch.equal(got_all, oracle_all) and torch.equal(got_last, oracle_last)


@pytest.mark.parametrize("t,d", [(64, 32), (256, 16)])
def test_k8_reference_rounds_as_one_fused_multiply_add(t, d):
    """Why the port rounds once: the reference's scan equals the
    FMA-contracted recurrence bit for bit (XLA on the CPU)."""
    x, dec, h0 = _scan_inputs(t, d, t * d)
    want_all, _ = jref.chunked_scan_ref(jnp.asarray(x), jnp.asarray(dec), jnp.asarray(h0))
    h, rows = torch.from_numpy(h0), []
    for i in range(t):
        h = fma_f32(torch.from_numpy(dec[i]), h, torch.from_numpy(x[i]))
        rows.append(h)
    assert np.array_equal(torch.stack(rows).numpy(), np.asarray(want_all))


def test_k8_rejects_bad_shapes_and_chunk():
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="expected"):
        ops.linear_scan(x, torch.zeros((8, 3)), torch.zeros(4))
    with pytest.raises(ValueError, match="chunk"):
        ops.linear_scan(x, x, torch.zeros(4), chunk=0)


@pytest.mark.parametrize("t", [1, 100, 4097, 32768])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 33, 36, 2048, 2050, 4096, 4100, 8192])
def test_k8_plan_fits_and_stages_by_tma_where_rows_align(t, d):
    """K8's plan: shared memory within the card's opt-in, TMA staging
    exactly where every row starts on 16 bytes (D % 4 == 0, aligned base
    addresses), 4-byte cp.async elsewhere; 128 CTAs at rwkv6's D = 2048."""
    for aligned in (True, False):
        p = k8.plan(t, d, aligned)
        assert p.mode == (k8.TMA if d % 4 == 0 and aligned else k8.CP_ASYNC)
        assert p.features in (8, 16, 32) and p.rows == k8.STAGE_ROWS
        assert k8.smem_bytes(p) <= 232448
        in_flight = 2 * 4 * p.stages * p.rows * p.features
        assert 25 * 1024 <= in_flight <= 64 * 1024
    if d == 2048:
        assert -(-d // k8.plan(t, d).features) == 128
