# Serving hot-path kernels and the backend that routes graph nodes to them:
#
#   csrc/*.cu        hand-written CUDA C++ for sm_90a (plain C interface)
#   build.py         nvcc at first use into _build/, loaded with ctypes
#   runtime.py       ctypes binding, launch checks, the shared launch counts
#   conv_fused.py    fused conv (f32, int32) and fc wrappers + plain versions
#   gemm.py          the unfused route's GEMM wrapper + plain version
#   im2col.py        the unfused route's patch-matrix wrapper + plain version
#   ops.py           entry points of the unfused kernels (mirrors repro's ops.py)
#   backend.py       per-node route selection (torch | cuda | cuda_fused)
#   config.py        device resolution
#   autotune.py      descriptor cache keys (the tuner itself comes later)
