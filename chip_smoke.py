#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them; turn TF32 off for matmuls and cuDNN.
  2. build: compile every kernel source from this checkout with nvcc for
     sm_90a, one nvcc per source, all started together, and print the
     build time and ptxas report.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the shapes its path gives it (bit equality for K1, stated
     tolerances for K2); time K1, its plain version and one PyTorch
     library call with CUDA events, beside the bound: the larger of the
     bytes over the card's memory rate and the fp32 operations over its
     fp32 rate.
  4. main path: ``repro_torch.launch.train.main`` — DTFL on full-width
     ResNet-56 (6 blocks per stage, width 16, 32 px, 8 modules, 7 tiers),
     10 clients, 2000 samples, batch 32, 3 rounds, the int8 wire codec,
     the dynamic scheduler, Adam 1e-3. Launch counts are zeroed just before
     and read after; every round must launch K1, and every parameter and
     aux head must stay finite and keep its shape.
  5. dcor run: the same entry point with Table 5's data and the
     distance-correlation regularizer — full-width ResNet-56, cifar10-noisy,
     5 IID clients, 1200 samples, batch 32, 3 rounds, ``--dcor-alpha 0.5``,
     identity codec. K2 counts are zeroed just before and read after; every
     round must launch the K2 forward and backward kernels.
  6. small-input reference: the same CLI on the reduced ResNet-56 runs on
     the card and on the CPU (plain versions, held against the JAX package
     by the CPU tests), once with the int8 codec and once with
     ``--dcor-alpha 0.5``; clocks, tier assignments and uplink bytes must be
     equal, parameters close.
  7. K2 times, as K1's in phase 3 plus device time from CUDA-graph
     replays, after the runs so the graphs' memory stays out of their peak;
     K1's device time the same way; then torch.profiler over K2's kernels
     (device time per kernel) and over two rounds of the dcor run (device
     busy share, K2's share, the top kernels), printed only.
  8. K3 and K4 (fused cross-entropy, flash attention), forward and
     backward, against their plain versions on the card at the transformer
     path's shapes and at ragged ones (the absolute tolerances of
     tests/test_torch_kernels.py: K4 fp32 2e-5 forward and 1e-4 backward,
     bf16 rtol 2e-2 with atol 1e-2; K3 loss 2e-4).
  9. transformer run: the same entry point on full-width SmolLM-360M (32
     layers, d_model 960, 15 query heads over 5 KV heads, d_ff 2560, vocab
     49,152, 8 modules, 7 tiers; weights random from seed 0), 4 clients,
     batch 4, sequence 512, 3 rounds, the token-LM task. K3 and K4 counts
     are zeroed just before and read after; every round must launch the
     forward and backward kernels of both, and every parameter and aux
     head must stay finite and keep its shape.
 10. the reduced SmolLM-360M on the card and on the CPU, as phase 6.
 11. K3 and K4 times as K2's, beside the bound (bytes over the memory
     rate, or bf16 products over the tensor-core rate) and one PyTorch
     call each (``F.cross_entropy``, ``F.scaled_dot_product_attention``),
     timed only; then torch.profiler over two rounds of the transformer
     run (device busy share, K3's and K4's shares, the top kernels),
     printed only.
Then one JSON line of kernel measurements (K1, K2, K3 and K4, forward and
backward), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TIMED_ITERS = 50


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {smi}")
    return smi


def phase_build():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import dcor, flash_attention, fused_xent, nvcc, quantize

    names = ("int8_roundtrip", "pairwise_dist", "fused_xent", "flash_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(nvcc.build, names))
    for mod in (quantize, dcor, fused_xent, flash_attention):
        mod.load_library()
    print(f"[build] {', '.join(names)} in parallel: {time.perf_counter() - t0:.2f} s")
    for name in names:
        print(nvcc.library_path(name).with_suffix(".log").read_text().strip())


def _bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
           ) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    bytes_ms, ops_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _cuda_ms(fn, x) -> float:
    import torch

    for _ in range(3):
        fn(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_ITERS):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_ITERS


def _graph_ms(fn, x) -> float:
    """Device time per call: TIMED_ITERS calls captured in one CUDA graph
    and replayed, so the host's per-call work (Python, allocation, launch)
    is left out. ``_cuda_ms`` times back-to-back calls, which a small
    kernel finishes faster than the host can issue them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_ITERS):
            fn(x)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_ITERS


def phase_kernels() -> dict:
    """K1 against its plain version at the main path's shapes; times at z."""
    import torch

    from repro_torch.kernels import quantize
    from repro_torch.kernels.ref import int8_roundtrip_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("z of tier md2/md3, 10 clients", (10, 2_097_152), torch.float32),
        ("largest parameter leaf, 10 clients", (10, 36_864), torch.float32),
        ("ragged row", (1, 177), torch.float32),
        ("bf16", (3, 4099), torch.bfloat16),
        ("a row of all zeros", (2, 1000), torch.float32),
    ]
    max_err = 0.0
    for label, shape, dtype in cases:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        if label == "a row of all zeros":
            x[1] = 0
        got = quantize.int8_roundtrip_rows(x)
        want = int8_roundtrip_ref(x)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"int8_roundtrip_rows differs from its plain version on {label} "
                 f"{shape} {dtype}: max |diff| {err}")
        if label == "a row of all zeros" and got[1].any():
            fail("a row of zeros did not round-trip to exact zeros")
        print(f"[kernels] int8_roundtrip {label} {tuple(shape)} {dtype}: bit-equal")

    x = torch.randn((10, 2_097_152), generator=g, device="cuda")
    rows, n = x.shape
    scale = (x.abs().amax(dim=1) / 127.0).contiguous()
    zero = torch.zeros(rows, dtype=torch.int32, device="cuda")
    ms = _cuda_ms(quantize.int8_roundtrip_rows, x)
    plain_ms = _cuda_ms(int8_roundtrip_ref, x)
    # yardstick only (timed here, never called by the port): PyTorch's
    # per-channel fake quantization of the same rows with a precomputed scale
    library_ms = _cuda_ms(
        lambda t: torch.fake_quantize_per_channel_affine(t, scale, zero, 0, -127, 127), x)
    bytes_moved = 2 * 4 * rows * n + 4 * rows        # x read, out written, scales
    ops = 7 * rows * n                               # abs, max, div, rint, 2 clamps, mul
    bound_ms, bound_by = _bound(bytes_moved, ops)
    entry = {
        "name": "int8_roundtrip",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_roundtrip.cu",
        "replaces": "src/repro/kernels/quantize.py:32",
        "launches": None,            # filled from the main path's run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    print(f"[kernels] int8_roundtrip at {tuple(x.shape)} fp32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
          f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


def _dist_errors(got, want, x) -> tuple[float, float, float]:
    """Hold K2's forward against its plain version (tolerances of
    tests/test_torch_kernels.py): off the diagonal within rtol 1e-4; the
    kernel's diagonal exactly sqrt(1e-12); the plain version's diagonal, its
    rounding noise, within sqrt(4 gamma_F max sq). Returns the max |diff|,
    the largest off-diagonal relative diff and the plain diagonal's max."""
    import torch

    from repro_torch.kernels.ref import D_MIN

    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device).expand_as(got)
    rel = float(((got - want).abs() / want)[~eye].max()) if x.shape[1] > 1 else 0.0
    u = 2.0 ** -24
    gamma = x.shape[-1] * u / (1 - x.shape[-1] * u)
    bound = max(4 * gamma * float((x.double() ** 2).sum(-1).max()) * (1 + 1e-6), 1e-12) ** 0.5
    plain_diag = float(want.diagonal(dim1=1, dim2=2).max())
    if rel > 1e-4:
        fail(f"pairwise_dist off-diagonal relative error {rel} > 1e-4")
    if not bool((got.diagonal(dim1=1, dim2=2) == D_MIN).all()):
        fail("pairwise_dist diagonal is not exactly sqrt(1e-12)")
    if plain_diag > bound:
        fail(f"plain pairwise_dist diagonal {plain_diag} above its bound {bound}")
    if not torch.equal(got, got.transpose(1, 2)):
        fail("pairwise_dist is not exactly symmetric")
    return float((got - want).abs().max()), rel, plain_diag


def _grad_error(got, want, x, dist, g) -> float:
    """Hold K2's backward against its plain version on the same (x, D, gD):
    |diff| <= 4 gamma_B * 2 (rowsum|S| |x_i| + |S| |x|), the sums of B
    terms taken in another order."""
    import torch

    from repro_torch.kernels.ref import D_MIN

    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)
    h = torch.where((dist > D_MIN) & ~eye, 0.5 * g / dist, torch.zeros_like(dist))
    s = (h + h.transpose(1, 2)).abs()
    scale = 2 * (s.sum(-1, keepdim=True) * x.abs() + torch.bmm(s, x.abs()))
    u = 2.0 ** -24
    gamma = x.shape[1] * u / (1 - x.shape[1] * u)
    if not bool(torch.isfinite(got).all()):
        fail("pairwise_dist backward gave non-finite values")
    if not bool(((got - want).abs() <= 4 * gamma * scale + 1e-30).all()):
        fail(f"pairwise_dist backward differs from its plain version: max |diff| "
             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max())


def phase_k2() -> tuple[float, float]:
    """K2 forward and backward against their plain versions at the dcor
    path's shapes (images 3,072; z of stage 1 up to 65,536), a ragged
    shape, B = 1 and a batch of identical rows. Returns the largest
    forward and backward |diff|."""
    import torch

    from repro_torch import privacy
    from repro_torch.kernels import dcor
    from repro_torch.kernels.ref import D_MIN, pairwise_dist_bwd_ref, pairwise_dist_ref

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        ("z after stage 1, 5 clients", (5, 32, 65_536)),
        ("z, 16,384", (5, 32, 16_384)),
        ("images, 5 clients", (5, 32, 3_072)),
        ("ragged", (3, 17, 1_001)),
        ("B = 1", (2, 1, 100)),
        ("identical rows", (2, 32, 3_072)),
    ]
    fwd_err = bwd_err = 0.0
    for label, shape in cases:
        x = torch.randn(shape, generator=g, device="cuda")
        if label == "identical rows":
            x = x[:, :1].expand(shape).contiguous()
        got = dcor.dist_forward(x)
        want = pairwise_dist_ref(x)
        gd = torch.randn(got.shape, generator=g, device="cuda")
        gx = dcor.dist_backward(x, got, gd)
        gx_want = pairwise_dist_bwd_ref(x, got, gd)
        torch.cuda.synchronize()
        if label == "identical rows":
            u = 2.0 ** -24
            gamma = shape[2] * u / (1 - shape[2] * u)
            bound = (4 * gamma * float((x.double() ** 2).sum(-1).max())) ** 0.5
            if not bool((got == D_MIN).all()) or float(want.max()) > bound:
                fail("identical rows: distances not at the clamp floor / within bound")
            if gx.any() or gx_want.any():
                fail("identical rows: the backward routed a gradient")
            z = torch.randn(2, 32, 500, generator=g, device="cuda", requires_grad=True)
            val = privacy.dcor(x, z)
            (gz,) = torch.autograd.grad(val.sum(), z)
            if not bool((val == 0).all()) or not bool(torch.isfinite(gz).all()):
                fail("identical rows: dcor is not exactly 0 with a finite gradient")
            err, rel, plain_diag = float((got - want).abs().max()), 0.0, float(want.max())
        else:
            err, rel, plain_diag = _dist_errors(got, want, x)
        gerr = _grad_error(gx, gx_want, x, got, gd)
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
        print(f"[kernels] pairwise_dist {label} {shape}: forward max |diff| {err:.3g} "
              f"(off-diagonal rel {rel:.3g}, plain diagonal max {plain_diag:.3g}), "
              f"backward max |diff| {gerr:.3g}")
    return fwd_err, bwd_err


def phase_k2_times(fwd_err: float, bwd_err: float) -> list[dict]:
    """K2's times at (5, 32, 65,536) and (5, 32, 3,072): CUDA events and
    CUDA-graph device time for the kernels and plain versions, events for
    the library yardsticks. Run after the training runs, so the graphs'
    memory pools stay out of their peak memory."""
    import torch

    from repro_torch.kernels import dcor
    from repro_torch.kernels.ref import pairwise_dist_bwd_ref, pairwise_dist_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    entries = []
    for shape in ((5, 32, 65_536), (5, 32, 3_072)):
        C, B, F = shape
        x = torch.randn(shape, generator=g, device="cuda")
        dist = dcor.dist_forward(x)
        gd = torch.randn(dist.shape, generator=g, device="cuda")
        xr = x.clone().requires_grad_(True)
        # yardsticks only (timed here, never called by the port): torch.cdist,
        # and its forward + backward for the backward
        fwd_fn = dcor.dist_forward
        bwd_fn = partial(dcor.dist_backward, dist=dist, g_dist=gd)
        fwd_plain = pairwise_dist_ref
        bwd_plain = partial(pairwise_dist_bwd_ref, dist=dist, g_dist=gd)
        fwd = {"ms": _cuda_ms(fwd_fn, x), "plain_ms": _cuda_ms(fwd_plain, x),
               "library_ms": _cuda_ms(lambda t: torch.cdist(t, t), x),
               "device_ms": _graph_ms(fwd_fn, x), "plain_device_ms": _graph_ms(fwd_plain, x)}
        bwd = {"ms": _cuda_ms(bwd_fn, x), "plain_ms": _cuda_ms(bwd_plain, x),
               "library_ms": _cuda_ms(
                   lambda t: torch.autograd.grad(torch.cdist(t, t), t, gd), xr),
               "device_ms": _graph_ms(bwd_fn, x), "plain_device_ms": _graph_ms(bwd_plain, x)}
        gram_ops = 2 * C * B * B * F
        fwd["bound_ms"], fwd["bound_by"] = _bound(4 * (C * B * F + C * B * B),
                                                  gram_ops + 6 * C * B * B)
        bwd["bound_ms"], bwd["bound_by"] = _bound(4 * (2 * C * B * F + 2 * C * B * B),
                                                  gram_ops + 8 * C * B * B)
        for name, t in (("forward", fwd), ("backward", bwd)):
            print(f"[kernels] pairwise_dist {name} at {shape} fp32: kernel {t['ms']:.4f} ms "
                  f"(device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms "
                  f"(device {t['plain_device_ms']:.4f} ms), library {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        if shape[2] == 65_536:
            for name, t, err in (("forward", fwd, fwd_err), ("backward", bwd, bwd_err)):
                entries.append({
                    "name": f"pairwise_dist_{name}",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/pairwise_dist.cu",
                    "replaces": "src/repro/kernels/dcor.py:28",
                    "launches": None,        # filled from the dcor run
                    "max_abs_err": err,
                    **t,
                })
    return entries


def _check_trees_finite(trainer, shapes=None) -> dict:
    import torch

    from repro_torch.tree import tree_leaves

    trees = {"params": trainer.params, **{f"aux{m}": a for m, a in trainer.aux.items()}}
    got = {}
    for name, tree in trees.items():
        leaves = tree_leaves(tree)
        for t in leaves:
            if not bool(torch.isfinite(t).all()):
                fail(f"non-finite values in {name}")
        got[name] = [tuple(t.shape) for t in leaves]
    if shapes is not None and got != shapes:
        fail("parameter or aux-head shapes changed during training")
    return got


def phase_main_path() -> int:
    import torch

    from repro_torch.kernels import quantize
    from repro_torch.launch import train

    argv = ["--arch", "resnet-56", "--full-size", "--clients", "10", "--samples", "2000",
            "--batch-size", "32", "--rounds", "3", "--codec", "int8",
            "--scheduler", "dynamic", "--lr", "1e-3", "--device", "cuda"]
    rounds = []
    shapes = {}

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        rounds.append((log, quantize.LAUNCHES))

    torch.cuda.reset_peak_memory_stats()
    quantize.LAUNCHES = 0
    logs = train.main(argv, on_round=on_round)
    launches = quantize.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    if len(logs) != 3 or len(rounds) != 3:
        fail(f"expected 3 rounds, got {len(logs)}")
    before = 0
    for log, count in rounds:
        if count <= before:
            fail(f"round {log.round} launched no int8_roundtrip kernel")
        tiers = sorted(set(log.assignment.values()))
        print(f"[main] round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, uplink_bytes {log.uplink_bytes:.0f}, tiers {tiers}, "
              f"acc {log.acc:.4f}, int8_roundtrip launches {count - before}")
        before = count
    print(f"[main] peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), int8_roundtrip launches {launches}")
    return launches


def phase_dcor_run() -> tuple[int, int]:
    """Table 5's data with the dcor regularizer at full width; every round
    must launch the K2 forward and backward kernels."""
    import torch

    from repro_torch.kernels import dcor
    from repro_torch.launch import train

    argv = ["--arch", "resnet-56", "--full-size", "--dataset", "cifar10-noisy",
            "--clients", "5", "--samples", "1200", "--iid", "--batch-size", "32",
            "--rounds", "3", "--dcor-alpha", "0.5", "--scheduler", "dynamic",
            "--lr", "1e-3", "--device", "cuda"]
    rounds = []
    shapes = {}

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        rounds.append((log, dict(dcor.LAUNCHES)))

    torch.cuda.reset_peak_memory_stats()
    dcor.LAUNCHES.update(forward=0, backward=0)
    logs = train.main(argv, on_round=on_round)
    launches = dict(dcor.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    if len(logs) != 3 or len(rounds) != 3:
        fail(f"dcor run: expected 3 rounds, got {len(logs)}")
    before = {"forward": 0, "backward": 0}
    for log, count in rounds:
        fwd, bwd = (count[k] - before[k] for k in ("forward", "backward"))
        if fwd <= 0 or bwd <= 0:
            fail(f"dcor run round {log.round} launched no K2 forward or backward kernel")
        tiers = sorted(set(log.assignment.values()))
        print(f"[dcor] round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, uplink_bytes {log.uplink_bytes:.0f}, tiers {tiers}, "
              f"acc {log.acc:.4f}, K2 launches forward {fwd} backward {bwd}")
        before = count
    print(f"[dcor] peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), K2 launches forward "
          f"{launches['forward']} backward {launches['backward']}")
    return launches["forward"], launches["backward"]


def _device_events(prof) -> list:
    """The profiled device-side events (kernels, copies, sets) only: a host
    op's own entry also carries its kernels' time and would count it twice.
    A kernel launched through ctypes is traced like any other."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _device_us(events, name: str) -> float:
    """Device time in microseconds of the events whose name holds ``name``."""
    return sum(e.self_device_time_total for e in events if name in e.key)


def phase_profile() -> None:
    """torch.profiler over K2's kernels and over one round of the dcor run:
    device time per kernel, the round's device busy share and K2's part of
    it, the top kernels. Only printed; a trace with no device time prints
    "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import dcor
    from repro_torch.launch import train

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((5, 32, 65_536), generator=g, device="cuda")
    dist = dcor.dist_forward(x)
    gd = torch.randn(dist.shape, generator=g, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(TIMED_ITERS):
            dcor.dist_forward(x)
            dcor.dist_backward(x, dist, gd)
        torch.cuda.synchronize()
    events = _device_events(prof)
    for name in ("gram_partial", "gram_finish", "dist_backward"):
        us = _device_us(events, name) / TIMED_ITERS
        print(f"[profile] K2 {name} at (5, 32, 65536): "
              + (f"{us / 1e3:.4f} ms device time per call" if us else "not measured"))

    argv = ["--arch", "resnet-56", "--full-size", "--dataset", "cifar10-noisy",
            "--clients", "5", "--samples", "1200", "--iid", "--batch-size", "32",
            "--rounds", "2", "--dcor-alpha", "0.5", "--scheduler", "dynamic",
            "--lr", "1e-3", "--device", "cuda"]
    walls = []
    with profile(activities=acts) as prof:
        train.main(argv, on_round=lambda trainer, log: walls.append(log.wall_s))
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not busy:
        print("[profile] dcor run: no device time in the trace (not measured)")
        return
    k2 = sum(_device_us(events, n) for n in ("gram_partial", "gram_finish", "dist_backward"))
    wall = sum(walls)
    print(f"[profile] dcor run, rounds 0-1 under the profiler: wall {wall:.3f} s, device "
          f"busy {busy:.3f} s ({busy / wall:.1%} of wall), K2 {k2 / 1e6:.4f} s "
          f"({k2 / 1e6 / busy:.2%} of device time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e6:.4f} s  {e.count:6d} x  {e.key[:90]}")


RESNET_SMALL = ["--arch", "resnet-56", "--clients", "4", "--samples", "200",
                "--batch-size", "16", "--rounds", "3"]
SMOLLM_SMALL = ["--arch", "smollm-360m", "--clients", "4", "--batch-size", "4",
                "--seq-len", "64", "--rounds", "3"]


def phase_small_reference(argv: list[str], label: str) -> None:
    """The CLI at a tiny size on the card against the CPU's plain path."""
    import numpy as np

    from repro_torch.bridge import to_numpy_tree
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    runs = {}
    for device in ("cuda", "cpu"):
        got = {}
        logs = train.main(argv + ["--device", device],
                          on_round=lambda tr, log: got.update(trainer=tr))
        runs[device] = (logs, got["trainer"])
    (glogs, gtr), (clogs, ctr) = runs["cuda"], runs["cpu"]
    for a, b in zip(glogs, clogs):
        if (a.clock, a.assignment, a.uplink_bytes) != (b.clock, b.assignment, b.uplink_bytes):
            fail(f"{label} round {a.round}: clock/assignment/uplink differ between "
                 f"card and CPU")
    # the bounds of tests/test_torch_dtfl.py, in units of lr * local steps
    unit = 1e-3 * 3 * max(c.n_batches for c in ctr.clients)
    d = np.concatenate([
        np.abs(x - y).ravel() for x, y in zip(
            tree_leaves(to_numpy_tree(gtr.params)), tree_leaves(to_numpy_tree(ctr.params)))])
    if d.max() > 0.5 * unit or np.quantile(d, 0.99) > 0.1 * unit or np.median(d) > 0.01 * unit:
        fail(f"{label}: card and CPU parameters differ: max {d.max() / unit} U, "
             f"99th percentile {np.quantile(d, 0.99) / unit} U, median {np.median(d) / unit} U")
    print(f"[reference] card vs CPU, reduced {argv[1]}, 3 {label} rounds: logs equal, "
          f"parameter |diff| max {d.max():.3g} ({d.max() / unit:.3g} U) median "
          f"{np.median(d):.3g} ({np.median(d) / unit:.3g} U), 99th percentile "
          f"{np.quantile(d, 0.99) / unit:.3g} U")


def phase_k1_device_time(entry: dict) -> None:
    """K1's device time (CUDA-graph replays) at the z shape, after the runs
    so the graph's memory stays out of their peak."""
    import torch

    from repro_torch.kernels import quantize
    from repro_torch.kernels.ref import int8_roundtrip_ref

    x = torch.randn((10, 2_097_152), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    entry["device_ms"] = _graph_ms(quantize.int8_roundtrip_rows, x)
    entry["plain_device_ms"] = _graph_ms(int8_roundtrip_ref, x)
    print(f"[kernels] int8_roundtrip at {tuple(x.shape)} fp32: device {entry['device_ms']:.4f} ms, "
          f"plain device {entry['plain_device_ms']:.4f} ms")


# K4 cases: (N, S, H, KV, hd, causal, window, dtype); the first two are the
# path's (16 sequences of 512 tokens, 15 query heads over 5 KV heads, hd 64)
ATTN_CASES = [
    ("path, bf16", 16, 512, 15, 5, 64, True, 0, "bfloat16"),
    ("path, fp32", 16, 512, 15, 5, 64, True, 0, "float32"),
    ("window 128", 4, 512, 15, 5, 64, True, 128, "bfloat16"),
    ("ragged S = 200", 3, 200, 6, 2, 64, True, 0, "float32"),
    ("G = 1", 3, 200, 4, 4, 64, True, 0, "float32"),
    ("reduced model, hd 32", 16, 64, 4, 4, 32, True, 0, "bfloat16"),
]
# K3 cases: (T, V, dtype): the path's heads, the ResNet's classifier, ragged
XENT_CASES = [
    ("path heads", 8_192, 49_152, "bfloat16"),
    ("ResNet classifier", 320, 10, "float32"),
    ("ragged", 1_000, 50_001, "bfloat16"),
]


def _close(got, want, rtol: float, atol: float) -> tuple[bool, float]:
    """|got - want| <= atol + rtol |want| everywhere, as torch.allclose
    (atol absolute, not scaled by the data); and the max |diff|."""
    want = want.float()
    diff = (got.float() - want).abs()
    return bool((diff <= atol + rtol * want.abs()).all()), float(diff.max())


def phase_k3_k4() -> dict:
    """K3 and K4, forward and backward, against their plain versions on the
    same inputs (the tolerances of tests/test_torch_kernels.py). Returns
    the largest |diff| of each of the four kernels."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels.ref import (attention_bwd_ref, attention_ref, fused_xent_bwd_ref,
                                         fused_xent_ref)

    g = torch.Generator(device="cuda").manual_seed(4)
    err = {"flash_attention_forward": 0.0, "flash_attention_backward": 0.0,
           "fused_xent_forward": 0.0, "fused_xent_backward": 0.0}
    for label, N, S, H, KV, hd, causal, window, dt in ATTN_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(N, S, H, hd, generator=g, device="cuda").to(dtype)
        k = torch.randn(N, S, KV, hd, generator=g, device="cuda").to(dtype)
        v = torch.randn(N, S, KV, hd, generator=g, device="cuda").to(dtype)
        do = torch.randn(N, S, H, hd, generator=g, device="cuda").to(dtype)
        o, lse = fa.attn_forward(q, k, v, causal=causal, window=window)
        grads = fa.attn_backward(q, k, v, o, lse, do, causal=causal, window=window)
        torch.cuda.synchronize()
        o_want, lse_want = attention_ref(q, k, v, causal=causal, window=window)
        want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
        # (rtol, atol): fp32 as tests/test_kernels.py:27; bf16 measured at
        # 4e-3 (forward) and 2e-3 (backward) on the H100, so 1e-2 absolute
        # leaves room and still catches a bf16 fault of a typical output's size
        fwd_tol, bwd_tol = (((2e-5, 2e-5), (1e-4, 1e-4)) if dtype == torch.float32
                            else ((2e-2, 1e-2), (2e-2, 1e-2)))
        ok, fwd = _close(o, o_want, *fwd_tol)
        if not ok or not torch.allclose(lse, lse_want, atol=1e-5, rtol=1e-5):
            fail(f"flash_attention forward differs from its plain version on {label}: "
                 f"max |diff| {fwd}")
        bwd = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), grads, want):
            ok, d = _close(a, b, *bwd_tol)
            bwd = max(bwd, d)
            if not ok:
                fail(f"flash_attention backward {name} differs from its plain version on "
                     f"{label}: max |diff| {d}")
        err["flash_attention_forward"] = max(err["flash_attention_forward"], fwd)
        err["flash_attention_backward"] = max(err["flash_attention_backward"], bwd)
        print(f"[kernels] flash_attention {label} {(N, S, H, KV, hd)} {dt} causal={causal} "
              f"window={window}: forward max |diff| {fwd:.3g}, backward max |diff| {bwd:.3g}")
    for label, T, V, dt in XENT_CASES:
        dtype = getattr(torch, dt)
        logits = (3 * torch.randn(T, V, generator=g, device="cuda")).to(dtype)
        labels = torch.randint(0, V, (T,), generator=g, device="cuda")
        gt = torch.randn(T, generator=g, device="cuda")
        loss, lse = fx.xent_forward(logits, labels)
        grad = fx.xent_backward(logits, labels, lse, gt)
        torch.cuda.synchronize()
        loss_want, lse_want = fused_xent_ref(logits, labels)
        fwd = float((loss - loss_want).abs().max())
        if fwd > 2e-4 or float((lse - lse_want).abs().max()) > 2e-4:
            fail(f"fused_xent forward differs from its plain version on {label}: {fwd}")
        ok, bwd = _close(grad, fused_xent_bwd_ref(logits, labels, lse, gt),
                         1e-5 if dtype == torch.float32 else 1e-2, 1e-6)
        if not ok or grad.dtype != dtype:
            fail(f"fused_xent backward differs from its plain version on {label}: {bwd}")
        err["fused_xent_forward"] = max(err["fused_xent_forward"], fwd)
        err["fused_xent_backward"] = max(err["fused_xent_backward"], bwd)
        print(f"[kernels] fused_xent {label} {(T, V)} {dt}: loss max |diff| {fwd:.3g}, "
              f"gradient max |diff| {bwd:.3g}")
    return err


TRANSFORMER_ARGV = ["--arch", "smollm-360m", "--full-size", "--clients", "4",
                    "--batch-size", "4", "--seq-len", "512", "--scheduler", "dynamic",
                    "--lr", "1e-3", "--device", "cuda"]


def _k3_k4_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx

    return {"fused_xent_forward": fx.LAUNCHES["forward"],
            "fused_xent_backward": fx.LAUNCHES["backward"],
            "flash_attention_forward": fa.LAUNCHES["forward"],
            "flash_attention_backward": fa.LAUNCHES["backward"]}


def phase_transformer_run() -> dict:
    """DTFL on full-width SmolLM-360M; every round must launch K3 and K4,
    forward and backward."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.launch import train

    rounds = []
    shapes = {}

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        rounds.append((log, _k3_k4_counts()))

    counters = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    stats0 = torch.cuda.memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    fx.LAUNCHES.update(forward=0, backward=0)
    fa.LAUNCHES.update(forward=0, backward=0)
    logs = train.main(TRANSFORMER_ARGV + ["--rounds", "3"], on_round=on_round)
    launches = _k3_k4_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = torch.cuda.memory_stats()

    if len(logs) != 3 or len(rounds) != 3:
        fail(f"transformer run: expected 3 rounds, got {len(logs)}")
    before = dict.fromkeys(launches, 0)
    for log, count in rounds:
        got = {k: count[k] - before[k] for k in count}
        if min(got.values()) <= 0:
            fail(f"transformer run round {log.round} launched no kernel of {got}")
        tiers = sorted(set(log.assignment.values()))
        print(f"[transformer] round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, uplink_bytes {log.uplink_bytes:.0f}, tiers {tiers}, "
              f"acc {log.acc:.4f}, launches K3 forward {got['fused_xent_forward']} backward "
              f"{got['fused_xent_backward']}, K4 forward {got['flash_attention_forward']} "
              f"backward {got['flash_attention_backward']}")
        before = count
    print(f"[transformer] peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), launches {launches}")
    # the caching allocator over the run: what it held before, and how often
    # it called cudaMalloc / cudaFree or retried after freeing its cache
    print(f"[transformer] allocator: {reserved0 / 2**30:.3f} GiB reserved before the run; "
          + ", ".join(f"{k} {stats.get(k, 0) - stats0.get(k, 0)}" for k in counters))
    return launches


def phase_k3_k4_times(err: dict) -> list[dict]:
    """K3 and K4 times at the path's shapes: CUDA events and CUDA-graph
    device time for the kernels and plain versions, events for the library
    yardsticks (timed here, never called by the port)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels.ref import (attention_bwd_ref, attention_ref, fused_xent_bwd_ref,
                                         fused_xent_ref)

    g = torch.Generator(device="cuda").manual_seed(5)
    entries = []

    # K4 at the path's shape: 16 sequences x 15 heads, S = 512, hd 64, causal, bf16
    N, S, H, KV, hd = 16, 512, 15, 5, 64
    q = torch.randn(N, S, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(N, S, KV, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(N, S, KV, hd, generator=g, device="cuda").bfloat16()
    do = torch.randn(N, S, H, hd, generator=g, device="cuda").bfloat16()
    o, lse = fa.attn_forward(q, k, v, causal=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # SDPA's (N, H, S, hd)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    sdpa = partial(F.scaled_dot_product_attention, is_causal=True, enable_gqa=True)
    fwd_fn = partial(fa.attn_forward, k=k, v=v, causal=True)
    bwd_fn = partial(fa.attn_backward, k=k, v=v, o=o, lse=lse, do=do, causal=True)
    fwd_plain = partial(attention_ref, k=k, v=v, causal=True)
    bwd_plain = partial(attention_bwd_ref, k=k, v=v, o=o, lse=lse, do=do, causal=True)
    dot = do.transpose(1, 2)
    attn = {
        "forward": {"ms": _cuda_ms(fwd_fn, q), "device_ms": _graph_ms(fwd_fn, q),
                    "plain_ms": _cuda_ms(fwd_plain, q), "plain_device_ms": _graph_ms(fwd_plain, q),
                    "library_ms": _cuda_ms(lambda t: sdpa(t, kt, vt), qt)},
        "backward": {"ms": _cuda_ms(bwd_fn, q), "device_ms": _graph_ms(bwd_fn, q),
                     "plain_ms": _cuda_ms(bwd_plain, q),
                     "plain_device_ms": _graph_ms(bwd_plain, q),
                     "library_ms": _cuda_ms(lambda t: torch.autograd.grad(
                         sdpa(t, kr, vr), (t, kr, vr), dot), qr)},
    }
    pairs = N * H * S * (S + 1) // 2                 # causal (query, key) pairs
    q_bytes, kv_bytes, lse_bytes = 2 * N * S * H * hd, 2 * N * S * KV * hd, 4 * N * H * S
    attn["forward"]["bound_ms"], attn["forward"]["bound_by"] = _bound(
        2 * q_bytes + 2 * kv_bytes + lse_bytes, 2 * 2 * pairs * hd, BF16_OPS_PER_S)
    attn["backward"]["bound_ms"], attn["backward"]["bound_by"] = _bound(
        4 * q_bytes + 4 * kv_bytes + lse_bytes, 5 * 2 * pairs * hd, BF16_OPS_PER_S)

    # K3 at the heads' shape: 4 clients x 4 sequences x 512 tokens, vocab 49,152, bf16
    T, V = 8_192, 49_152
    logits = (3 * torch.randn(T, V, generator=g, device="cuda")).bfloat16()
    labels = torch.randint(0, V, (T,), generator=g, device="cuda")
    gt = torch.randn(T, generator=g, device="cuda")
    _, xlse = fx.xent_forward(logits, labels)
    lr = logits.clone().requires_grad_(True)
    xfwd = partial(fx.xent_forward, labels=labels)
    xbwd = partial(fx.xent_backward, labels=labels, lse=xlse, g=gt)
    xfwd_plain = partial(fused_xent_ref, labels=labels)
    xbwd_plain = partial(fused_xent_bwd_ref, labels=labels, lse=xlse, g=gt)
    xent = {
        "forward": {"ms": _cuda_ms(xfwd, logits), "device_ms": _graph_ms(xfwd, logits),
                    "plain_ms": _cuda_ms(xfwd_plain, logits),
                    "plain_device_ms": _graph_ms(xfwd_plain, logits),
                    "library_ms": _cuda_ms(lambda t: F.cross_entropy(t, labels, reduction="none"),
                                           logits)},
        "backward": {"ms": _cuda_ms(xbwd, logits), "device_ms": _graph_ms(xbwd, logits),
                     "plain_ms": _cuda_ms(xbwd_plain, logits),
                     "plain_device_ms": _graph_ms(xbwd_plain, logits),
                     "library_ms": _cuda_ms(lambda t: torch.autograd.grad(
                         F.cross_entropy(t, labels, reduction="none"), t, gt), lr)},
    }
    xent["forward"]["bound_ms"], xent["forward"]["bound_by"] = _bound(
        2 * T * V + 8 * T + 8 * T, 3 * T * V)
    xent["backward"]["bound_ms"], xent["backward"]["bound_by"] = _bound(
        2 * 2 * T * V + 8 * T + 8 * T, 4 * T * V)

    for name, times, src, replaces, shape in (
            ("flash_attention", attn, "flash_attention.cu", "flash_attention.py:75",
             "(16, 512, 15/5, 64) bf16 causal"),
            ("fused_xent", xent, "fused_xent.cu", "fused_xent.py:62", "(8192, 49152) bf16")):
        for direction in ("forward", "backward"):
            t = times[direction]
            print(f"[kernels] {name} {direction} at {shape}: kernel {t['ms']:.4f} ms (device "
                  f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms (device "
                  f"{t['plain_device_ms']:.4f} ms), library {t['library_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
            entries.append({
                "name": f"{name}_{direction}",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": None,        # filled from the transformer run
                "max_abs_err": err[f"{name}_{direction}"],
                **t,
            })
    return entries


def phase_transformer_profile() -> None:
    """torch.profiler over two rounds of the transformer run: the device busy
    share, K3's and K4's shares, the top kernels. Printed only."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    # the trainer (and its initial weights' copy to the card) outside the trace
    trainer, eval_batch = train.build(train.build_parser().parse_args(TRANSFORMER_ARGV))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logs = trainer.run(2, eval_batch)
    walls = [log.wall_s for log in logs]
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not busy:
        print("[profile] transformer run: no device time in the trace (not measured)")
        return
    k3 = sum(_device_us(events, n) for n in ("xent_fwd", "xent_bwd")) / 1e6
    k4 = sum(_device_us(events, n) for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")) / 1e6
    wall = sum(walls)
    print(f"[profile] transformer run, rounds 0-1 under the profiler: wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({busy / wall:.1%} of wall), K3 {k3:.4f} s "
          f"({k3 / busy:.2%} of device time), K4 {k4:.4f} s ({k4 / busy:.2%})")
    for name in ("xent_fwd", "xent_bwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        n = sum(e.count for e in events if name in e.key)
        us = _device_us(events, name)
        print(f"[profile]   {name}: {n} calls, {us / 1e6:.4f} s"
              + (f", {us / n / 1e3:.4f} ms per call" if n else ""))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e6:.4f} s  {e.count:6d} x  {e.key[:90]}")


def main() -> None:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    entry = phase_kernels()
    k2_err = phase_k2()
    k34_err = phase_k3_k4()
    k1_launches = phase_main_path()
    k2_launches = phase_dcor_run()
    k34_launches = phase_transformer_run()
    phase_small_reference(RESNET_SMALL + ["--codec", "int8"], "int8")
    phase_small_reference(RESNET_SMALL + ["--dcor-alpha", "0.5"], "dcor")
    phase_small_reference(SMOLLM_SMALL, "token-LM")
    entry["launches"] = k1_launches
    phase_k1_device_time(entry)
    k2_fwd, k2_bwd = phase_k2_times(*k2_err)
    k2_fwd["launches"], k2_bwd["launches"] = k2_launches
    k34 = phase_k3_k4_times(k34_err)
    for e in k34:
        e["launches"] = k34_launches[e["name"]]
    phase_profile()
    phase_transformer_profile()

    import torch

    print(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry, k2_fwd, k2_bwd] + k34}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
