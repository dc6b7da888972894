# Hot-path kernels and the backend that routes CNN graph nodes to them:
#
#   csrc/*.cu        hand-written CUDA C++ for sm_90a (plain C interface)
#   build.py         nvcc at first use into _build/, loaded with ctypes
#   runtime.py       ctypes binding, launch checks, the shared launch counts
#   conv_fused.py    fused conv (f32, quantized u8) and fc wrappers + plain versions
#                    (the f32 conv and the fc GEMM are entries of csrc/gemm.cu)
#   gemm.py          the unfused route's GEMM wrapper + plain version
#   im2col.py        the unfused route's patch-matrix wrapper + plain version
#   flash_decode.py  decode attention over a KV cache (B5) + plain version
#   ssd.py           SSD chunked scan (B6) + plain version (the port's ssd_scan)
#   ops.py           entry points of the other kernels (mirrors repro's ops.py)
#   backend.py       per-node route selection (torch | cuda | cuda_fused)
#   config.py        device resolution, IEEE f32 for the library convs
#   autotune.py      B1's tile-variant tuner and the route-time cache (CUDA events)
