# Serving hot-path kernels and the backend that routes graph nodes to them:
#
#   csrc/*.cu        hand-written CUDA C++ for sm_90a (plain C interface)
#   build.py         nvcc at first use into _build/, loaded with ctypes
#   conv_fused.py    wrappers + plain PyTorch versions + launch counts
#   backend.py       per-node route selection (torch | cuda_fused)
#   config.py        device resolution
#   autotune.py      descriptor cache keys (the tuner itself comes later)
