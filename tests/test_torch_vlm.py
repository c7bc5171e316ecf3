"""The port's VLM family (internvl2-76b) against the JAX package's.

The JAX package's reduced internvl2-76b (float32, ``naive`` attention: 2
dense layers, d_model 64, 4 query heads over 2 KV heads, head dim 16, 8
patches) goes through both packages with the same weights: the JAX
model's own, carried across by ``convert.model_params_from_numpy`` (shared
checks in ``torch_lm_family.py``).  Tokens, labels and patches
(``normal(0, 0.1)``, as ``tests/test_models.py`` makes them) are made
from a seed with numpy.  The loss puts the patches ahead of the text; prefill and decode read the text only, as the
reference's do.  Tolerances: 1e-5 for the loss, the gradients and the
prefill (float32, sums in another order); a train step within 4 times
JAX's own spread (see ``test_train_step``); 1e-4 for decode over 8
steps; greedy tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_family as FAM
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import LAUNCHES
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.launch.steps import make_eval_step, make_prefill_step

ARCH = "internvl2-76b"


@pytest.fixture(scope="module")
def pair():
    return FAM.make_pair(ARCH)


def test_config_equals_jax_field_for_field():
    FAM.config_equal(ARCH)
    cfg, red = get_config(ARCH), get_config(ARCH).reduced()
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.num_patches,
            cfg.padded_vocab) == ("vlm", 80, 8192, 64, 8, 128, 28672, 256,
                                  128256)
    assert (red.num_layers, red.num_patches, red.d_model,
            red.dtype) == (2, 8, 64, "float32")


def test_convert_keeps_every_leaf(pair):
    bf = FAM.convert_keeps_every_leaf(pair)
    assert len(pair[3]["stack"]) == 2
    assert FAM.bf16_leaves(bf["stack"][0]) == {"wq", "wk", "wv", "wo", "wg",
                                               "wu", "wd"}


@pytest.fixture(scope="module")
def grads(pair):
    return FAM.loss_and_grads(pair, FAM.batch(pair[2].cfg, seed=7))


def test_loss_and_grads_match_jax(grads):
    FAM.grads_match(grads)


def test_tokens_count_text_only(grads):
    """4 x 16 text labels, 3 masked: 61 tokens, none of the 4 x 8 patch
    positions."""
    assert float(grads["tmet"]["tokens"]) == \
        float(grads["jmet"]["tokens"]) == 61.0


def test_patches_reach_the_text(pair):
    """Other patches give another loss, in both packages alike."""
    jm, jp, tm, tp = pair
    b = FAM.batch(tm.cfg, B=2, seed=8)
    b2 = dict(b, patches=b["patches"] + 0.1)
    losses = []
    for batch in (b, b2):
        jl, _ = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, _ = tm.loss_fn(tp, {k: FAM.t(v) for k, v in batch.items()})
        assert FAM.rel(tl, jl) <= FAM.TOL
        losses.append(float(tl))
    assert abs(losses[0] - losses[1]) > 1e-3


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_and_decode_are_the_text_ones(pair, flash):
    """The prefill (flash kernel's plain version, or the naive route) of a
    text prompt, its logits and cache, then 4 decode steps from that cache,
    against JAX's prefill and decode (which read no patches)."""
    jm, jp, tm, tp = pair
    B, S_, cache_seq = 2, 8, 12
    toks = FAM.prompt(tm.cfg, B, S_ + 4, 1)
    want, wc = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp, jnp.asarray(
            toks[:, :S_]))
    got, gc = tm.prefill(tp, {"tokens": FAM.t(toks[:, :S_]),
                              "cache_seq": cache_seq}, flash=flash)
    FAM.close(got, want)
    FAM.same_leaves(gc, wc, FAM.TOL, "prefill cache")
    step = jax.jit(jm.decode_step)
    for s in range(S_, S_ + 4):
        want, wc = step(jp, {"token": jnp.asarray(toks[:, s:s + 1]),
                             "pos": jnp.asarray(s, jnp.int32), "cache": wc})
        got, gc = tm.decode_step(tp, {"token": FAM.t(toks[:, s:s + 1]),
                                      "pos": s, "cache": gc})
        FAM.close(got, want, FAM.DECODE_TOL)


def test_decode_logits_and_cache_over_8_steps(pair):
    FAM.decode_8_steps(pair)


def test_prefill_step_launches_nothing_on_the_cpu(pair):
    _, _, tm, tp = pair
    before = LAUNCHES["flash_attention"]
    logits, cache = make_prefill_step(tm.cfg, "cpu")[1](
        tp, {"tokens": FAM.prompt(tm.cfg, 1, 6, 3), "cache_seq": 8})
    assert LAUNCHES["flash_attention"] == before
    assert bool(torch.isfinite(logits).all())
    assert tuple(cache["k"].shape) == (2, 1, 8, 2, 16)


def test_eval_step_carries_the_patches(pair):
    _, _, tm, tp = pair
    b = FAM.batch(tm.cfg, B=2, seed=9)
    met = make_eval_step(tm.cfg, "cpu")[1](tp, b)
    want, _ = tm.loss_fn(tp, {k: FAM.t(v) for k, v in b.items()})
    assert float(met["loss"]) == float(want)
    assert float(met["tokens"]) == 2 * 16 - 3


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_tokens_match_jax_decode_loop(pair, prefetch):
    FAM.engine_tokens(pair, prefetch)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step(mb):
    """At microbatches 2 each slice of the batch carries its slice of the
    patches.  At this step's weights and batch JAX's own gradient moves by
    up to 9e-5 relative under half-ulp weight changes (zero patches
    alike), so it is held as the recurrent families' are (``spread``)."""
    FAM.train_step_matches(ARCH, mb, spread=True)


def test_serve_and_train_mains_on_the_cpu(tmp_path, capsys):
    """The serving CLI (text) and the training CLI, whose batches carry
    zero patches of (B, num_patches, d_model), as the reference's."""
    out = S.main(["--arch", ARCH, "--reduce", "--device", "cpu"])
    assert out.shape == (4, 16) and (out >= 0).all() and (out < 256).all()
    hist = T.main(["--arch", ARCH, "--reduce", "--steps", "2", "--batch",
                   "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
                   "--log-every", "1"], device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert f"arch={ARCH}" in capsys.readouterr().out


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_cuda_prefill_launches_the_kernel_once_a_layer(pair):
    """On the card the reduced prefill launches the kernel once a layer
    and agrees with the CPU within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    _, _, tm, tp = pair
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = {"tokens": FAM.prompt(tm.cfg, 2, 8, 13), "cache_seq": 12}
    before = LAUNCHES["flash_attention"]
    got, _ = make_prefill_step(tm.cfg, dev)[1](
        FAM.tree_map(lambda x: x.to(dev), tp), batch)
    assert LAUNCHES["flash_attention"] - before == tm.cfg.num_layers
    want, _ = make_prefill_step(tm.cfg, "cpu")[1](tp, batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
