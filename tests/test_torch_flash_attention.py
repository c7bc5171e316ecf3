"""The port's flash attention against the JAX package's.

On the CPU ``repro_torch.kernels.flash_attention.flash_attention`` runs its
plain version (``ref.flash_attention_ref``); it is held to the JAX Pallas
kernel run in interpret mode, as ``tests/test_kernels.py`` runs it.
Tolerances: float32 2e-5 (the two sum in another order), bfloat16 2e-2
(outputs rounded to bf16; those of ``tests/test_kernels.py``).  On a card
only, the CUDA kernel is held to the plain version (``cuda`` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention import (
    LAUNCHES, attention_ref, flash_attention, flash_attention_ref,
    uses_tensor_cores)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(rng, B, Sq, Skv, H, KV, D):
    return (rng.normal(0, 1, (B, Sq, H, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32))


def _port(arrs, tdt, **kw):
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    return flash_attention(q, k, v, **kw).float().numpy()


def _jax(arrs, jdt, **kw):
    q, k, v = (jnp.asarray(a, jdt) for a in arrs)
    return np.asarray(jax_flash(q, k, v, **kw), np.float32)


# the shapes of tests/test_kernels.py:40-50
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,Sq,H,KV,D,causal,window",
    [
        (2, 128, 4, 4, 64, True, None),
        (1, 256, 4, 2, 64, True, None),
        (2, 128, 2, 2, 32, True, 64),
        (1, 64, 2, 1, 128, False, None),
        (1, 128, 8, 8, 16, True, None),
    ],
)
def test_flash_matches_jax_kernel(B, Sq, H, KV, D, causal, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(B * Sq + H + D)
    arrs = _qkv(rng, B, Sq, Sq, H, KV, D)
    want = _jax(arrs, jdt, causal=causal, window=window, bq=64, bk=64)
    got = _port(arrs, tdt, causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 32)])
def test_flash_left_aligned_when_sq_below_skv(causal, window):
    """Sq < Skv: query row i sits at position i (left-aligned), as in the
    TPU kernel; run the kernel itself, heads repeated for it."""
    rng = np.random.default_rng(5)
    B, Sq, Skv, H, KV, D = 1, 64, 128, 4, 2, 32
    q, k, v = _qkv(rng, B, Sq, Skv, H, KV, D)
    kr, vr = np.repeat(k, H // KV, 2), np.repeat(v, H // KV, 2)
    want = np.asarray(flash_attention_kernel(
        *(jnp.asarray(a.swapaxes(1, 2)) for a in (q, kr, vr)),
        causal=causal, window=window, bq=64, bk=64,
        interpret=True)).swapaxes(1, 2)
    got = _port((q, k, v), torch.float32, causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_ragged_length_matches_jax_wrapper(dtype):
    """S=100 is no multiple of the port's 64-row tiles (the JAX wrapper
    shrinks its blocks to divide it)."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(np.random.default_rng(7), 2, 100, 100, 4, 2, 64)
    want = _jax(arrs, jdt, causal=True)
    got = _port(arrs, tdt, causal=True)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_flash_window_first_tile_outside_some_rows():
    """S=256, window=64, tiles of 64: the first KV tile a query tile
    visits lies wholly outside the window of some of its rows, which the
    finite NEG_INF carries through (p = 1 there, cleared by alpha = 0)."""
    arrs = _qkv(np.random.default_rng(11), 1, 256, 256, 2, 2, 32)
    want = _jax(arrs, jnp.float32, causal=True, window=64, bq=64, bk=64)
    got = _port(arrs, torch.float32, causal=True, window=64)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_attention_ref_matches_jax_oracle(dtype, causal, window):
    """The port of the right-aligned oracle, at Sq == Skv where it agrees
    with the kernel's left alignment."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(np.random.default_rng(3), 2, 48, 48, 4, 4, 16)
    want = np.asarray(jax_attention_ref(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
        window=window), np.float32)
    got = attention_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                        causal=causal, window=window).float().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    flash = _port((q, k, v), torch.float32, causal=causal,
                  window=window)
    if dtype == "float32":
        np.testing.assert_allclose(flash, want, atol=2e-5, rtol=2e-5)


def test_right_and_left_alignment_differ_when_sq_below_skv():
    """The reason the port states its alignment: at Sq < Skv the oracle's
    right alignment is another function."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(2), 1, 16, 32, 2, 2, 8))
    left = flash_attention_ref(q, k, v, causal=True)
    right = attention_ref(q, k, v, causal=True)
    assert (left - right).abs().max() > 0.1


def test_gqa_reads_kv_head_by_index():
    """Query head h reads KV head h // G: the same as repeating KV heads."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(4), 2, 40, 40, 6, 2, 8))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q, k.repeat_interleave(3, 2),
                           v.repeat_interleave(3, 2), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(1), 1, 8, 8, 2, 1, 16))
    before = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v))
    assert not uses_tensor_cores(q, k, v)  # float32: the FMA route


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    bad = [
        ((q.half(), kv.half(), kv.half()), {}, "dtype"),
        ((q, kv.bfloat16(), kv), {}, "dtype"),
        ((torch.zeros(1, 8, 4, 272), torch.zeros(1, 8, 2, 272),
          torch.zeros(1, 8, 2, 272)), {}, "head dim"),
        ((q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16)), {},
         "group"),
        ((q, kv, torch.zeros(1, 9, 2, 16)), {}, "match"),
        ((q[0], kv, kv), {}, "4-D"),
        ((q, kv, kv), {"window": 0}, "window"),
    ]
    for args, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            flash_attention(*args, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,Skv,H,KV,D,causal,window", [
    (128, 128, 8, 2, 128, True, None),
    (100, 100, 4, 4, 64, True, None),
    (64, 192, 4, 1, 64, False, None),
    (256, 256, 2, 2, 128, True, 64),
    (96, 96, 2, 1, 32, True, None),
])
def test_cuda_kernel_equals_plain_version(cuda_device, dtype, tol, Sq, Skv,
                                          H, KV, D, causal, window):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(Sq + D)
    q = torch.randn(2, Sq, H, D, generator=g).to(cuda_device, dtype)
    k = torch.randn(2, Skv, KV, D, generator=g).to(cuda_device, dtype)
    v = torch.randn(2, Skv, KV, D, generator=g).to(cuda_device, dtype)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.fixture
def wgmma_case(cuda_device, request):
    """q, k, v on the card for one edge case of the tensor-core route
    (128-row query tiles, 128-key tiles), K and V as views of a longer
    cache when ``strided``."""
    Sq, Skv, H, KV, D, causal, window, strided = request.param
    g = torch.Generator().manual_seed(Sq * 7 + Skv + D)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda_device,
                                                   torch.bfloat16)

    q = rnd(2, Sq, H, D)
    if strided:
        k = rnd(2, Skv + 72, KV, D)[:, :Skv]
        v = rnd(2, Skv + 72, KV, D)[:, :Skv]
    else:
        k, v = rnd(2, Skv, KV, D), rnd(2, Skv, KV, D)
    return q, k, v, causal, window


@pytest.mark.cuda
@pytest.mark.parametrize("wgmma_case", [
    (127, 127, 4, 2, 128, True, None, False),    # one row short of a tile
    (129, 129, 4, 2, 64, True, None, False),     # one row past a tile
    (255, 255, 4, 1, 128, True, None, False),
    (300, 300, 2, 2, 128, True, 100, False),     # window across 128-key tiles
    (300, 300, 4, 2, 64, True, 100, False),
    (100, 260, 4, 2, 128, True, None, False),    # Sq < Skv
    (129, 333, 4, 2, 64, False, None, False),
    (200, 200, 8, 2, 128, True, None, True),     # strided cache views
    (255, 255, 4, 2, 64, False, None, True),
], indirect=True)
def test_cuda_wgmma_route_tile_edges(wgmma_case):
    q, k, v, causal, window = wgmma_case
    assert uses_tensor_cores(q, k, v)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
