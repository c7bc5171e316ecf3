"""Digests of the flash kernel's outputs on the card, at the shapes of
``chip_smoke.py``'s checks (phase ``kernels``) and timings (phase
``times``), from fixed seeds: run it against two checkouts' packages and
compare the two JSON lines to hold a kernel change to the earlier bits.

    python scripts/flash_digests.py <checkout>/src > old.json
    python scripts/flash_digests.py src --q-offset-zero > new.json

``--q-offset-zero`` passes ``q_offset=0`` (a kernel with the argument).
Needs a CUDA card.
"""
import hashlib
import json
import sys

# (B, Sq, Skv, H, KV, D, causal, window), v at D, in float32 and bfloat16
SMALL = ((2, 128, 128, 8, 2, 64, True, None),
         (2, 128, 128, 4, 4, 128, True, None),
         (1, 192, 192, 4, 2, 128, False, None),
         (1, 256, 256, 4, 2, 64, True, 64),
         (1, 256, 256, 2, 1, 128, True, 100),
         (2, 64, 192, 4, 2, 64, True, None),
         (1, 64, 192, 4, 1, 128, False, None),
         (2, 100, 100, 4, 2, 128, True, None),
         (1, 100, 100, 4, 4, 64, False, 30),
         (1, 96, 96, 4, 2, 32, True, None),
         (1, 80, 80, 2, 1, 256, True, None),
         (2, 127, 127, 4, 2, 128, True, None),
         (2, 129, 129, 4, 2, 64, True, None),
         (1, 255, 255, 4, 1, 128, True, None),
         (1, 300, 300, 2, 2, 128, True, 100),
         (1, 300, 300, 4, 2, 64, True, 100),
         (2, 100, 260, 4, 2, 128, True, None),
         (1, 129, 333, 4, 2, 64, False, None))
# the model paths' shapes, bfloat16: (..., Dv)
FULL = ((2, 4096, 4096, 40, 8, 128, True, None, 128),
        (2, 8192, 8192, 48, 8, 128, True, 4096, 128),
        (2, 4096, 4096, 128, 128, 192, True, None, 128),
        (8, 1500, 1500, 16, 16, 64, False, None, 64),
        (8, 224, 1500, 16, 16, 64, False, None, 64),
        (8, 224, 224, 16, 16, 64, True, None, 64),
        (2, 4096, 4096, 64, 8, 128, True, None, 128))


def main() -> None:
    sys.path.insert(0, sys.argv[1])
    import torch

    from repro_torch.kernels.flash_attention import flash_attention

    offset = sys.argv[2:] == ["--q-offset-zero"]
    dev = torch.device("cuda")
    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [(dt,) + c + (c[5],) for c in SMALL]
        cases += [(dt, 2, 300, 300, 4, 4, 192, True, None, 128),
                  (dt, 2, 100, 100, 4, 2, 24, True, None, 16)]
    cases += [("bfloat16",) + c for c in FULL]
    out = {}
    for i, case in enumerate(cases):
        dt, B, Sq, Skv, H, KV, D, causal, window, Dv = case
        g = torch.Generator(device=dev).manual_seed(i)
        dtype = getattr(torch, dt)
        q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, Skv, KV, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, Skv, KV, Dv), generator=g, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        if offset:
            kw["q_offset"] = 0
        o = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        out[str(case)] = hashlib.blake2b(
            o.contiguous().view(-1).view(torch.uint8).cpu().numpy()
            .tobytes(), digest_size=16).hexdigest()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
