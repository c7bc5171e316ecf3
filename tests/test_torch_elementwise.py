"""The card's half of the elementwise kernels' and the MoE backward's
checks (no JAX: it runs where the card is, ``-m cuda``).  On a machine
without a card every test skips; ``tests/test_torch_silu.py`` holds the
plain versions to JAX on the CPU.

Tolerance: 0.  ``silu_stepwise`` and ``gelu_stepwise`` equal their plain
chains bit for bit (NaN where NaN), on odd sizes (the tail), a view off a
16-byte boundary (the kernel's one-element loop), a transposed view (its
layout kept) and the special values; the MoE layer's input gradient is
the same bits in two backward passes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import elementwise as EW
from repro_torch.models import moe as TMOE

SPECIALS = [0.0, -0.0, np.inf, -np.inf, np.nan, -90.0, 90.0, 1e-30, -1e-30,
            88.0, -88.0, 5e-39]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_kernel_equals_plain_version(cuda_device, act, dtype):
    kern = {"silu": EW.silu_stepwise, "gelu": EW.gelu_stepwise}[act]
    plain = {"silu": EW.silu_stepwise_ref, "gelu": EW.gelu_stepwise_ref}[act]
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for n in (1, 7, 4099, 1 << 20):
        x = np.random.default_rng(n).normal(0, 3, n + len(SPECIALS))
        x[:len(SPECIALS)] = SPECIALS
        x = torch.from_numpy(x).to(cuda_device, dtype)
        m = x.numel() // 2 * 2
        for v in (x, x[1:], x[:m].view(2, -1).t()):
            EW.reset_launch_counts()
            got = kern(v)
            assert EW.LAUNCHES[f"{act}_stepwise"] == 1
            want = plain(v)
            assert got.stride() == v.stride()    # a dense layout is kept
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan)
            assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


@pytest.mark.cuda
def test_cuda_moe_backward_is_bitwise_deterministic(cuda_device):
    """Two backward passes of the reduced mixtral's MoE layer (bf16
    weights, a float32 input) on the card: the same bits."""
    cfg = get_config("mixtral-8x22b").reduced(dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    p = TMOE.init_moe(gen, cfg, torch.bfloat16, cuda_device)
    x0 = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda_device)
    grads = []
    for _ in range(2):
        x = x0.clone().requires_grad_()
        TMOE.apply_moe(p, x, cfg, dtype=torch.bfloat16).float().square() \
            .sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
