#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them; turn TF32 off for matmuls and cuDNN.
  2. build: compile every kernel of the main path from this checkout with
     nvcc for sm_90a, and print the build time and ptxas report.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the main path's shapes (bit equality for K1), and time the
     kernel, the plain version and one PyTorch library call with CUDA
     events, beside the bound from the card's memory rate.
  4. main path: ``repro_torch.launch.train.main`` — DTFL on full-width
     ResNet-56 (6 blocks per stage, width 16, 32 px, 8 modules, 7 tiers),
     10 clients, 2000 samples, batch 32, 3 rounds, the int8 wire codec,
     the dynamic scheduler, Adam 1e-3. Launch counts are zeroed just before
     and read after; every round must launch K1, and every parameter and
     aux head must stay finite and keep its shape.
  5. small-input reference: the same CLI on ``resnet-micro`` runs on the
     card and on the CPU (plain versions, held against the JAX package by
     the CPU tests); clocks, tier assignments and uplink bytes must be
     equal, parameters close.
Then one JSON line of kernel measurements, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
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
    from repro_torch.kernels import nvcc, quantize

    t0 = time.perf_counter()
    quantize.load_library()
    print(f"[build] int8_roundtrip: {time.perf_counter() - t0:.2f} s")
    print(nvcc.library_path("int8_roundtrip").with_suffix(".log").read_text().strip())


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
    bytes_ms, ops_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    entry = {
        "name": "int8_roundtrip",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_roundtrip.cu",
        "replaces": "src/repro/kernels/quantize.py:32",
        "launches": None,            # filled from the main path's run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    print(f"[kernels] int8_roundtrip at {tuple(x.shape)} fp32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
          f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


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


def phase_small_reference() -> None:
    """The CLI at a tiny size on the card against the CPU's plain path."""
    import numpy as np

    from repro_torch.bridge import to_numpy_tree
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    argv = ["--arch", "resnet-56", "--clients", "4", "--samples", "200",
            "--batch-size", "16", "--rounds", "3", "--codec", "int8"]
    runs = {}
    for device in ("cuda", "cpu"):
        got = {}
        logs = train.main(argv + ["--device", device],
                          on_round=lambda tr, log: got.update(trainer=tr))
        runs[device] = (logs, got["trainer"])
    (glogs, gtr), (clogs, ctr) = runs["cuda"], runs["cpu"]
    for a, b in zip(glogs, clogs):
        if (a.clock, a.assignment, a.uplink_bytes) != (b.clock, b.assignment, b.uplink_bytes):
            fail(f"round {a.round}: clock/assignment/uplink differ between card and CPU")
    # the bounds of tests/test_torch_dtfl.py, in units of lr * local steps
    unit = 1e-3 * 3 * max(c.n_batches for c in ctr.clients)
    d = np.concatenate([
        np.abs(x - y).ravel() for x, y in zip(
            tree_leaves(to_numpy_tree(gtr.params)), tree_leaves(to_numpy_tree(ctr.params)))])
    if d.max() > 0.5 * unit or np.quantile(d, 0.99) > 0.1 * unit or np.median(d) > 0.01 * unit:
        fail(f"card and CPU parameters differ: max {d.max()}, median {np.median(d)}")
    print(f"[reference] card vs CPU, reduced resnet-56, 3 int8 rounds: logs equal, "
          f"parameter |diff| max {d.max():.3g} median {np.median(d):.3g}")


def main() -> None:
    smi = phase_device()
    phase_build()
    entry = phase_kernels()
    entry["launches"] = phase_main_path()
    phase_small_reference()

    import torch

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
