"""The port's counterpart of ``jax.jit`` on the CPU: what a CUDA graph
needs of the code it captures, and what runs eagerly where no card is.

A decode step is captured once and replayed at every position, so the
position and B5's valid prefix live on the device: ``serve_step`` takes
``pos`` as a 0-d int32 tensor, ``_ring_write`` computes its slot there,
and ``flash_decode`` takes ``length`` as an int32 tensor that no host code
reads.  These tests hold each tensor form against the int form and
against the JAX package (its Pallas kernel in interpret mode), and the
CPU paths of the graph wrappers (``kernels/graphs.py``,
``serving/engine.py::build_stage_fns``, ``launch/steps.py``) to the eager
functions they wrap.  The graphs themselves run only on a card
(tests/test_torch_gpu.py).

Tolerances: ``2e-4`` for B5 (the reference's bar,
tests/test_kernels.py), ``1e-4`` for the reduced model's logits (as
tests/test_torch_models.py); the tensor and int forms of one port
function are held bitwise where they run the same operations, and at
``2e-4`` where the plain B5 masks slots instead of slicing them off.
"""
from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.flash_decode import flash_decode as ref_flash_decode
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import serve_step as ref_serve_step
from repro.models.blocks import _ring_write as ref_ring_write
from repro_torch.cnn.graph import Graph
from repro_torch.configs import get_config
from repro_torch.core.pipeline import Pipeline, PipelinePlan
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import graphs, ops, runtime
from repro_torch.launch import serve as S
from repro_torch.launch.steps import GraphedServeStep, make_serve_step
from repro_torch.models import init_cache, init_params, params_from_numpy, prefill, serve_step
from repro_torch.models.blocks import _ring_write
from repro_torch.models.model import N_META_TOKENS, embed_inputs
from repro_torch.serving import build_eager_stage_fns, build_stage_fns

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

FD_TOL = 2e-4
MODEL_TOL = 1e-4


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pos(p: int) -> torch.Tensor:
    return torch.tensor(p, dtype=torch.int32)


# ------------------------------------------------ B5's length on the device
@pytest.mark.parametrize("w,d,g", [(64, 32, 4), (300, 64, 5)], ids=["W64", "W300"])
def test_flash_decode_ref_tensor_length_matches_int_and_reference(w, d, g):
    """The plain version masks the slots past a tensor length; at lengths
    1, W - 1 and W it agrees with the int form (which slices them off) and
    with the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(w + d)
    q, k, v = _np(rng, g, d, scale=0.5), _np(rng, w, d, scale=0.5), _np(rng, w, d)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    q4, k4, v4 = qt[None, None], kt[None, :, None], vt[None, :, None]
    before = runtime.launch_counts()
    for length in (1, w - 1, w):
        got = ops.flash_decode(q4, k4, v4, torch.tensor([length], dtype=torch.int32))[0, 0]
        as_int = ops.flash_decode(q4, k4, v4, length)[0, 0]
        want = np.asarray(ref_flash_decode(q, k, v, jnp.int32(length), block_s=64, interpret=True))
        np.testing.assert_allclose(got.numpy(), as_int.numpy(), rtol=FD_TOL, atol=FD_TOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=FD_TOL, atol=FD_TOL)
    assert runtime.launch_counts() == before  # the CPU route launches nothing


def test_flash_decode_tensor_length_is_clamped_and_checked():
    """A device length outside [1, W] is clamped there, as the kernel does;
    a length that is not one int32 is refused."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_np(rng, *s)) for s in ((2, 2, 3, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    for outside, inside in ((0, 1), (-5, 1), (41, 40), (1000, 40)):
        np.testing.assert_allclose(FD.flash_decode_ref(q, k, v, _pos(outside)).numpy(),
                                   FD.flash_decode_ref(q, k, v, inside).numpy(), rtol=FD_TOL, atol=FD_TOL)
    for bad in (torch.tensor([3], dtype=torch.int64), torch.tensor([3, 4], dtype=torch.int32)):
        with pytest.raises(ValueError, match="one int32"):
            ops.flash_decode(q, k, v, bad)


# ------------------------------------------------ the ring write's slot
@pytest.mark.parametrize("start", [40, 60], ids=["before_wrap", "across_wrap"])
def test_ring_write_at_a_tensor_position_matches_int_and_reference(start):
    """Decode writes at positions made from a 0-d tensor (as ``embed_inputs``
    makes them) leave the cache that positions made on the host leave, and
    the reference's, across the ring's wrap (W = 64)."""
    rng = np.random.default_rng(start)
    b, w, hkv, d, steps = 2, 64, 2, 16, 8
    k, v = _np(rng, b, steps, hkv, d), _np(rng, b, steps, hkv, d)

    def empty():
        return {"k": torch.zeros(b, w, hkv, d), "v": torch.zeros(b, w, hkv, d),
                "pos": torch.full((w,), -1, dtype=torch.int32)}

    on_host, on_device = empty(), empty()
    ref = {"k": jnp.zeros((b, w, hkv, d)), "v": jnp.zeros((b, w, hkv, d)), "pos": jnp.full((w,), -1, jnp.int32)}
    for i in range(steps):
        p = start + i
        ki, vi = torch.from_numpy(k[:, i:i + 1]), torch.from_numpy(v[:, i:i + 1])
        _ring_write(on_host, ki, vi, torch.tensor([p], dtype=torch.int32))
        _ring_write(on_device, ki, vi, _pos(p) + torch.arange(1, dtype=torch.int32))
        ref = ref_ring_write(ref, jnp.asarray(k[:, i:i + 1]), jnp.asarray(v[:, i:i + 1]),
                             jnp.asarray([p], jnp.int32))
    for key in ("k", "v", "pos"):
        assert torch.equal(on_device[key], on_host[key]), key
        np.testing.assert_array_equal(on_device[key].numpy(), np.asarray(ref[key]))


def test_embed_inputs_takes_a_tensor_position():
    cfg = get_config("hymba-1.5b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros(2, 1, dtype=torch.long)
    _, at_int, _, _ = embed_inputs(cfg, model, {"tokens": tokens}, 191, mode="decode")
    _, at_tensor, _, _ = embed_inputs(cfg, model, {"tokens": tokens}, _pos(191), mode="decode")
    assert at_tensor.dtype == torch.int32 and torch.equal(at_tensor, at_int)


# ------------------------------------------------ the decode step
@pytest.fixture(scope="module")
def reduced_pair():
    """(reference config, port config, reference params, port model): the
    reduced Hymba, G = 2, in f32, on the reference's weights."""
    rcfg = dataclasses.replace(ref_get_config("hymba-1.5b").reduced(), n_kv_heads=2, compute_dtype="float32")
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_kv_heads=2, compute_dtype="float32")
    rp = ref_init_params(rcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return rcfg, cfg, rp, model


def test_decode_step_with_a_tensor_position_matches_int_and_reference(reduced_pair):
    """A prompt of 60 (188 tokens with the meta tokens) and 8 decode steps:
    the window layers' ring (W = 64) wraps at position 192.  Steps at a 0-d
    tensor position give the int form's logits bit for bit, and the
    reference's ``serve_step`` (``pos`` a traced ``jnp.int32``) within 1e-4."""
    rcfg, cfg, rp, model = reduced_pair
    prompt_len, steps = 60, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt_len + steps)).astype(np.int32)
    max_len = prompt_len + N_META_TOKENS + steps
    rc = ref_init_cache(rcfg, 2, max_len)
    _, rc = ref_prefill(rcfg, rp, {"tokens": jnp.asarray(toks[:, :prompt_len])}, rc)
    c_int, c_tensor = (init_cache(cfg, 2, max_len, device="cpu") for _ in range(2))
    for c in (c_int, c_tensor):
        prefill(cfg, model, {"tokens": torch.from_numpy(toks[:, :prompt_len]).long()}, c)
    for i in range(steps):
        pos = prompt_len + N_META_TOKENS + i
        t = toks[:, prompt_len + i:prompt_len + i + 1]
        want, rc = ref_serve_step(rcfg, rp, rc, jnp.asarray(t), jnp.int32(pos))
        tt = torch.from_numpy(t).long()
        at_int = serve_step(cfg, model, c_int, tt, pos)
        at_tensor = serve_step(cfg, model, c_tensor, tt, _pos(pos))
        assert torch.equal(at_tensor, at_int), pos
        np.testing.assert_allclose(at_tensor.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL)
    for a, b in zip(c_int, c_tensor):
        assert torch.equal(a["attn"]["pos"], b["attn"]["pos"])
        assert torch.equal(a["attn"]["k"], b["attn"]["k"])


def test_graphed_serve_step_runs_eagerly_on_the_cpu(reduced_pair):
    """On CPU tensors the captured step is the eager step: no graph, the
    same logits, at int and tensor positions alike."""
    _, cfg, _, model = reduced_pair
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))).long()
    c1, c2 = (init_cache(cfg, 2, 6 + N_META_TOKENS + 3, device="cpu") for _ in range(2))
    for c in (c1, c2):
        prefill(cfg, model, {"tokens": prompt}, c)
    step = make_serve_step(cfg)
    assert isinstance(step, GraphedServeStep)
    tok = prompt[:, -1:]
    for i in range(3):
        pos = 6 + N_META_TOKENS + i
        got = step(model, c1, tok, pos if i % 2 else _pos(pos))
        assert torch.equal(got, serve_step(cfg, model, c2, tok, pos))
        tok = got.argmax(-1)[:, None]
    assert step.graph is None


def test_generate_eager_equals_generate_on_the_cpu(reduced_pair):
    _, cfg, _, model = reduced_pair
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 5))).long()
    a = S.generate(cfg, model, prompt, 4, keep_logits=4)
    b = S.generate(cfg, model, prompt, 4, keep_logits=4, graphs=False)
    assert torch.equal(a["tokens"], b["tokens"])
    assert all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"]))
    assert a["steady_ms_per_step"] > 0  # steps 2 and 3, on the host clock


# ------------------------------------------------ the launch tally
def test_capture_tally_is_the_capturing_threads_own():
    """While one thread records (as it does during a capture), another
    thread's launches count in the global table and never in the tally;
    a replay adds the tally and counts one graph launch."""
    runtime.reset_launches()
    started, release = threading.Event(), threading.Event()

    def other_thread():
        started.set()
        release.wait(5)
        for _ in range(5):
            runtime.count("gemm")

    t = threading.Thread(target=other_thread)
    t.start()
    with runtime.recording() as tally:
        started.wait(5)
        release.set()
        for _ in range(3):
            runtime.count("gemm")
        runtime.count("im2col")
        t.join()
    assert tally["gemm"] == 3 and tally["im2col"] == 1
    assert runtime.launch_counts()["gemm"] == 5 and runtime.launch_counts()["im2col"] == 0
    runtime.count("gemm")  # outside the block: the global table again
    assert tally["gemm"] == 3 and runtime.launch_counts()["gemm"] == 6
    runtime.add_launches({"gemm": 3, "im2col": 1})
    assert runtime.launch_counts()["gemm"] == 9 and runtime.launch_counts()["im2col"] == 1
    assert runtime.graph_launches() == 1
    runtime.reset_launches()
    assert runtime.graph_launches() == 0 and not any(runtime.launch_counts().values())


def test_tensor_core_launches_count_beside_their_wrappers():
    """csrc/gemm.cu's tensor-core launches count under ``<wrapper>_tc``
    beside the wrapper's own count, through a capture's tally and its
    replay too; ``launch_counts()`` shows them only when asked."""
    runtime.reset_launches()
    with runtime.recording() as tally:
        runtime.count("conv2d_fused")
        runtime.count("conv2d_fused_tc")
    runtime.add_launches(tally)
    runtime.count("gemm")
    runtime.count("gemm_tc")
    assert set(runtime.launch_counts()) == set(runtime.KERNEL_NAMES)
    counts = runtime.launch_counts(tensor_cores=True)
    assert set(counts) == set(runtime.KERNEL_NAMES + runtime.TENSOR_CORE_NAMES)
    assert {k: counts[k] for k in ("conv2d_fused", "conv2d_fused_tc", "gemm", "gemm_tc", "matmul_fused_tc")} == \
        {"conv2d_fused": 1, "conv2d_fused_tc": 1, "gemm": 1, "gemm_tc": 1, "matmul_fused_tc": 0}
    runtime.reset_launches()
    assert not any(runtime.launch_counts(tensor_cores=True).values())


def test_recordings_nest():
    with runtime.recording() as outer:
        runtime.count("ssd")
        with runtime.recording() as inner:
            runtime.count("ssd")
        runtime.count("ssd")
    assert outer["ssd"] == 2 and inner["ssd"] == 1


# ------------------------------------------------ stage functions on the CPU
def _tiny():
    g = Graph("tiny", (16, 16, 3))
    a = g.conv("c1", "input", 8, 3)
    a = g.conv("c2", a, 8, 3, stride=2)
    a = g.pool_max("p1", a, 2, 2)
    a = g.fc("fc1", a, 10)
    g.softmax("sm", a)
    return g


@pytest.mark.parametrize("backend", ["torch", "cuda_fused", "cuda"])
def test_build_stage_fns_on_the_cpu_runs_the_eager_functions(backend):
    g = _tiny()
    params = g.init(seed=0, device="cpu")
    n = len(g.descriptors())
    plan = PipelinePlan(pipeline=Pipeline(stages=(("B", 2), ("s", 2))),
                        allocation=(tuple(range(2)), tuple(range(2, n))))
    x = torch.from_numpy(_np(np.random.default_rng(6), 3, 16, 16, 3))
    before = runtime.launch_counts()
    envs = []
    for build in (build_eager_stage_fns, build_stage_fns):
        fns = build(g, plan, backend=backend)
        env = {"input": x}
        for fn in fns:
            env = fn(params, env)
        envs.append(env)
    assert runtime.launch_counts() == before and runtime.graph_launches() == 0
    assert envs[0].keys() == envs[1].keys()
    for key in envs[0]:
        assert torch.equal(envs[0][key], envs[1][key])
    assert all(isinstance(fn, graphs.GraphedFn) and not fn.graphs for fn in fns)
