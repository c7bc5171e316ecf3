"""Hand-written CUDA kernels for Hopper (sm_90a), one folder per family.

parsa_cost/ — packed-bitmask popcount cost tile, the fused greedy select,
              and the Algorithm 2 refine sweep

Each family ships ``csrc/*.cu`` (the kernels), ``build.py`` (nvcc + ctypes,
at first use), ``ops.py`` (checked wrappers with launch counters) and
``ref.py`` (the plain PyTorch versions the CPU runs and the card is held to).
"""
