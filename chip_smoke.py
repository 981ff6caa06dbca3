#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --k3 [SRC]`` runs K3 alone from the port under SRC
(this checkout's ``src`` by default): its build report, its cases against
the plain versions and its timed rows (``k3_alone``); run on two checkouts
in turns within one call, it compares them on one card.

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them; turn TF32 off for matmuls and cuDNN.
  2. build: compile every kernel source from this checkout with nvcc for
     sm_90a, one nvcc per source, all started together, and print the
     build time and ptxas report; then one line per K2 kernel (registers,
     shared memory, stack, spills; all 20 instantiations must be there, and
     the forward's blocks an SM must be kernels/dcor.py's) and per K4
     kernel: registers, shared memory and spills (ptxas) and HMMA
     instructions (``cuobjdump -sass``). Every bf16 K4 kernel must have
     HMMA, and the hd-64 ones, the path's, must spill nothing. Per K3
     kernel: registers, stack, spills and its main loop's static SASS
     instructions per element streamed; none may have a stack frame. The
     same for K5: every kernel with
     split-TF32 products must have ``HMMA.1688.F32.TF32`` (m16n8k8 TF32) and
     none may spill (one build serves every head dim up to 512).
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the shapes its path gives it (bit equality for K1, stated
     tolerances for K2, at the dcor path's shapes, the transformers' with
     dcor (4, 4, 491,520) and (4, 4, 1,048,576) and ragged ones; K2
     reruns must be bit-identical); time K1, its plain version and one PyTorch
     library call with CUDA events, beside the bound: the larger of the
     bytes over the card's memory rate and the fp32 operations over its
     fp32 rate.
  4. main path: ``repro_torch.launch.train.main`` — DTFL on full-width
     ResNet-56 (6 blocks per stage, width 16, 32 px, 8 modules, 7 tiers),
     10 clients, 2000 samples, batch 32, 3 rounds, the int8 wire codec,
     the dynamic scheduler, Adam 1e-3. Launch counts are zeroed just before
     and read after (K1's and K3's); every round must launch K1, and every
     parameter and aux head must stay finite and keep its shape.
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
  7. K2 times at (5, 32, 65,536), (5, 32, 3,072), (4, 4, 491,520) and
     (4, 4, 1,048,576), as
     K1's in phase 3 plus device time from CUDA-graph replays (the
     kernels, their plain versions and the library yardsticks), after the
     runs so the graphs' memory stays out of their peak; K1's device time
     and its yardstick's the same way; then torch.profiler over K2's kernels
     (device time per kernel) and over two rounds of the dcor run (device
     busy share, K2's share, the top kernels), printed only.
  8. K3 and K4 (fused cross-entropy, flash attention), forward and
     backward, against their plain versions on the card at the transformer
     path's shapes, at ragged ones and at the full-width heads of the LLM
     configs (K4 at 8 sequences of 512 tokens: granite-3-2b 32/8 heads at
     hd 64, yi-6b 32/4, deepseek-67b 64/8, deepseek-moe-16b 16/16 and
     llama4-scout 40/8 at hd 128; K3 in bf16 at (8,192, 49,155) and
     (2,048, 49,155), granite's odd vocab, whose rows are not 16-byte
     aligned, (2,048, 64,000), (4,096, 102,400) and (2,048, 202,048)), K4's
     every shape in bf16 and fp32 (the absolute tolerances of
     tests/test_torch_kernels.py: K4 fp32 2e-5 forward and 1e-4 backward,
     bf16 rtol 2e-2 with atol 1e-2; K3 loss 2e-4, gradient rtol 1e-5 fp32
     and 1e-2 bf16); K4's backward and both K3 kernels must be
     bit-identical run to run. At the path's
     bf16 shape it also prints what K4's split of dS into bf16 hi + lo
     keeps against dS rounded to one bf16.
  9. transformer run: the same entry point on full-width SmolLM-360M (32
     layers, d_model 960, 15 query heads over 5 KV heads, d_ff 2560, vocab
     49,152, 8 modules, 7 tiers; weights random from seed 0), 4 clients,
     batch 4, sequence 512, 3 rounds, the token-LM task. K3 and K4 counts
     are zeroed just before and read after; every round must launch the
     forward and backward kernels of both, and every parameter and aux
     head must stay finite and keep its shape. Then every shape K3
     launched at is held against its plain version, as after the main
     path (4), the dcor (5), xLSTM (13) and baselines (22) runs; the
     errors join K3's ``max_abs_err``.
 10. the reduced SmolLM-360M on the card and on the CPU, as phase 6.
 11. K3 and K4 times as K2's, beside the bound (bytes over the memory
     rate, or bf16 products over the tensor-core rate) and one PyTorch
     call each (``F.cross_entropy``, ``F.scaled_dot_product_attention``),
     timed only, by events and in CUDA graphs; then torch.profiler over
     two rounds of the transformer run (device busy share, K3's and K4's
     shares, the top kernels), printed only.
 12. K5 (the mLSTM chunk kernels), forward and backward, against the plain
     chunk form and autograd through it on the card, at the xLSTM path's
     shape (48, 512, 512), the reduced model's (24, 320, 64) and ragged
     ones (an odd head dim among them), within the absolute tolerances of
     tests/test_torch_kernels.py (h 2e-4; dq 2e-3; dv 2e-4; dk, d log_f, d
     i 2e-2); the backward must be bit-identical run to run. At the path's
     shape and at S = 300, each output's error against the plain chunk form
     in float64 must be at most 4x the fp32 plain form's own.
 13. xLSTM run: the same entry point on full-width xLSTM-350M (24 layers,
     d_model 1024, 4 heads, mLSTM head dim 512, an sLSTM block every 8th
     layer, vocab 50,304, 8 modules, 7 tiers; weights random from seed 0),
     3 clients, batch 4, sequence 512, 3 rounds, the token-LM task. K5 and
     K3 counts are zeroed just before and read after; every round must
     launch K5's forward and backward kernels and K3's, and every parameter
     and aux head must stay finite and keep its shape.
 14. the reduced xLSTM-350M at 320 tokens (two K5 chunks) on the card and
     on the CPU, as phase 6.
 15. K5 times as K3's and K4's (no single PyTorch call computes an mLSTM,
     so no library yardstick), beside the bound: the fp32 operations this
     run's chunks need over the fp32 rate, and beside it the split-TF32
     bound (three times those operations over the TF32 tensor-core rate);
     torch.profiler over ten K5 forwards and backwards (device time per call
     of each K5 kernel); then torch.profiler over two rounds of the xLSTM
     run (device busy share, K5's and K3's shares, the top kernels), printed
     only. Every profile records device activity only and reads the raw
     trace.
 16. population run: the same entry point on full-width ResNet-56, 64 of
     100,000 lazily built clients a round (64 samples each, batch 32), the
     chunked plane at 16 clients a chunk, ``--codec topk0.05``, 3 rounds.
     Per round: wall, simulated clock, tiers, uplink bytes, the clients
     touched (at most the sampled ones and client 0, whose batch size the
     trainer reads), the clients holding residuals (every one sampled) and
     the seconds of the residuals' host-device copies with their share of
     the round's wall; then the peak device memory. Every parameter and aux
     head must stay finite, and every round's uplink bytes must equal
     ``wire_sizes``' own count.
 17. pairing loop run: 8 clients, 1,600 samples, ``--topology pairing
     --exec loop --codec int8``, 3 rounds, under torch.profiler (device
     activity only): per round the hosts, K1's launches (every round must
     launch it: each single-client upload is one K1 call per leaf) and
     their device time.
 18. events run: 10 clients, 2,000 samples, ``--engine events --churn
     --codec topk0.05``, 3 rounds; per round wall, clock, straggler, tiers,
     uplink bytes (checked as in 16) and the clients holding residuals.
 19. the reduced ResNet-56 on the card and on the CPU, as phase 6, with
     top-k on the population plane (chunks of 2, 4 of 50 clients a round)
     and with pairing on the loop plane (int8); hosts must be equal too.
     Then the chunked plane (chunks of 2) against the cohort plane on the
     card, with top-k, once with tier changes and once with every client on
     tier 0: logs must be equal; the largest difference of parameters, aux
     heads and residuals is printed, and whether they are bit-equal.
 20. resume run: full-width ResNet-56, 10 clients, top-k: 4 rounds, then 2
     with ``--out-ckpt`` and 4 with ``--resume``; rounds 2-3 held to the
     uninterrupted run; the envelope's bytes, save and load seconds.
 21. async run: 10 clients, ``--engine async --n-groups 3 --codec int8``,
     3 waves a group: per merge clock, group, wall and K1 launches; then
     the resume and the async runs at ``resnet-micro`` on the card and on
     the CPU, as phase 6.
 22. baselines run: the seven full-model baselines through the same entry
     point (``--method``) on full-width ResNet-56, 10 clients, 2,000
     samples, batch 32, 3 rounds: fedavg, fedyogi, tifl and drop30 with
     ``--codec int8``, splitfed and fedgkt with the identity codec, fedat
     with ``--engine async --n-groups 3 --codec int8`` (wave 0 and 9
     merges). K1 and K3 counts are zeroed before each run; per round or
     merge wall, simulated clock, trained clients, uplink bytes (which must
     equal ``wire_sizes``' full-model upload times the clients the log's
     plan trains) and K1 and K3 launches: every int8 round and merge must
     launch K1, every round and merge K3 forward and backward. Every
     parameter (FedGKT: also its edge model, server model and aux head)
     must be finite and shaped as a fresh init; each run's peak reserved
     memory; then FedAvg's simulated clock over DTFL's (phase 4's),
     printed only.
 23. the reduced ResNet-56 on the card and on the CPU, as phase 6, for
     fedavg with int8, tifl, fedgkt and fedat (async, int8); each run's
     trained clients must be equal too.
The LLM configs (after phase 14; ``LLM_RUNS``, ``LLM_ARCHS``). The
configs keep their published widths; the depth and the client count are
cut until one card holds the run, by a reckoning from the shapes on the
meta device (``_llm_reckoning``: 28 B a client-parameter for the cohort's
state, the global model and aux heads, the logits, Adam's temporaries),
printed before each run beside its measured peak:
 24. granite-3-2b with dcor: full width (d_model 2048, 32 query heads over
     8 KV heads, hd 64, d_ff 8192, vocab 49,155), 4 layers in 4 modules,
     priced on the full 40-layer config, 4 clients, batch 4 x 512, 3
     rounds, ``dcor_alpha`` 0.5: K2 at (4, 4, 1,048,576), K3 at (8,192,
     49,155), K4 at (16, 512, 32/8, 64). Built through the port's
     ``DTFLTrainer`` and ``TransformerAdapter`` as the CLI builds a
     transformer run (the CLI has no depth flag). Per round wall, clock,
     tiers, uplink bytes and K2, K3 and K4 launches: every round must
     launch each forward and backward; every parameter and aux head must
     stay finite and keep its shape. Each cohort (one a tier) launches the
     kernels at its own client count, so after the run, with the trainer
     freed, every shape K2, K3 and K4 launched at (the wrappers'
     ``SHAPES``) is held against its plain version as phases 3 and 8
     hold theirs; their errors join the kernels' ``max_abs_err``.
 25. yi-6b at full width (d_model 4096, 32/4 heads, hd 128, d_ff 11,008,
     vocab 64,000), 2 layers in 2 modules, 2 clients, batch 4 x 512, 2
     rounds, as 24 with K3 and K4.
 26. deepseek-moe-16b at full width (d_model 2048, 16/16 heads at hd 128,
     64 routed experts top-6 at d_ff 1408, 2 shared at 2816, vocab
     102,400), 2 layers in 2 modules, 1 client, batch 4 x 512, 3 rounds, as
     25; per round also each layer's share of dropped (token, k)
     assignments and ``moe_aux``, on client 0's first batch through the
     global model.
 27. the reduced variants of the five configs on the card and on the CPU,
     as phase 6 (granite-3-2b also with ``--dcor-alpha 0.5``); for the MoE
     configs the count of routes that differ when the CPU run's final model
     routes one batch on the card and on the CPU.
 28. (at the end) K4 at deepseek-moe-16b's heads (8, 512, 16/16, 128) and
     K3 at the rest of ``K3_TIMED`` (granite's (8,192, 49,155) and
     (2,048, 49,155), deepseek's (4,096, 102,400) and (2,048, 102,400),
     yi-6b's (2,048, 64,000) and (4,096, 64,000) in bf16, the ResNet's
     classifier (320, 10) in fp32), timed as phase 11; then
     torch.profiler over two rounds of the MoE run (host and device
     activity, input shapes): the device busy share, K3's and K4's shares,
     the dispatch and combine einsums' share (every ``aten::bmm`` over the
     group's E x capacity expert slots, forward and backward), the top
     kernels and the top operators by their kernels' device time, with
     their input shapes. Printed only.
Every phase first waits, up to CARD_WAIT_S seconds over the whole run, until
the card has the device memory it needs free: another process on the same
card (a second run started beside this one) may hold its memory until it
ends. A phase that runs out of device memory while another process holds
memory on the card is run again, in full, once that memory is free; any
other failure, or a second one, ends the run. Each phase prints its peak
of reserved memory and its seconds.
Then one JSON line of kernel measurements (K1, K2, K3, K4 and K5, forward
and backward), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial
from itertools import product
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
TIMED_ITERS = 50


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


CARD_WAIT_S = 600.0            # the most the whole run waits for another process
_card_waited = [0.0]


def _others_gib() -> float:
    """Device memory held outside this process's allocator, in GiB (this
    process's CUDA context, well under 1 GiB, included)."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return (total - free - torch.cuda.memory_reserved()) / 2**30


def _await_card(label: str, need_gib: float) -> None:
    """Wait until the card has ``need_gib`` GiB free for phase ``label``,
    after releasing this process's cached blocks; fail once the waits of
    the whole run pass CARD_WAIT_S."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    if free >= need_gib * 2**30:
        return
    print(f"[wait] {label}: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free, "
          f"{need_gib} GiB needed, {_others_gib():.2f} GiB held outside this process; "
          "waiting", flush=True)
    t0 = time.perf_counter()
    while free < need_gib * 2**30:
        if _card_waited[0] + time.perf_counter() - t0 > CARD_WAIT_S:
            fail(f"{label}: the card never had {need_gib} GiB free in {CARD_WAIT_S:.0f} s "
                 f"of waiting ({free / 2**30:.2f} GiB free)")
        time.sleep(2)
        free, _ = torch.cuda.mem_get_info()
    waited = time.perf_counter() - t0
    _card_waited[0] += waited
    print(f"[wait] {label}: {free / 2**30:.2f} GiB free after {waited:.1f} s", flush=True)


def _phase(label: str, need_gib: float, fn, *args):
    """``fn(*args)`` once the card has ``need_gib`` GiB free. Out of device
    memory while more than 2 GiB are held outside this process, it waits and
    runs ``fn`` again, once; every other failure ends the run."""
    import torch

    for attempt in (1, 2):
        _await_card(label, need_gib)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except torch.OutOfMemoryError as e:
            others = _others_gib()
            if attempt == 2 or others <= 2:
                raise
            reason = str(e).splitlines()[0]
        else:
            print(f"[mem] {label}: peak reserved "
                  f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB, "
                  f"{time.perf_counter() - t0:.1f} s")
            return out
        # out of the except block, so that the failed attempt's tensors are freed
        print(f"[wait] {label}: out of device memory with {others:.2f} GiB held outside "
              f"this process ({reason}); running the phase again", flush=True)


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
    from repro_torch.kernels import (dcor, flash_attention, fused_xent, mlstm_chunk, nvcc,
                                     quantize)

    names = nvcc.SOURCES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(nvcc.build, names))
    for mod in (quantize, dcor, fused_xent, flash_attention, mlstm_chunk):
        mod.load_library()
    print(f"[build] {', '.join(names)} in parallel: {time.perf_counter() - t0:.2f} s")
    for name in names:
        print(nvcc.library_path(name).with_suffix(".log").read_text().strip())
    k2_build_report()
    k3_build_report()
    k4_build_report()
    k5_build_report()


def _ptxas_report(log: str) -> dict:
    """{mangled kernel: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}} from an ``-Xptxas -v`` log (smem: static shared memory;
    stack: the local-memory frame, spills included; bytes)."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line):
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and (
                m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                               r"(\d+) bytes spill loads", line)):
            cur["stack"] = int(m.group(1))
            cur["spill_stores"], cur["spill_loads"] = int(m.group(2)), int(m.group(3))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return out


def _sass(lib: Path) -> dict:
    """{mangled function: [(address, instruction)]} from ``cuobjdump -sass``."""
    import re

    from repro_torch.kernels import nvcc

    sass = subprocess.run([str(Path(nvcc.nvcc_path()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = out.setdefault(line.split("Function : ", 1)[1].strip(), [])
        elif cur is not None and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)):
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def _hmma_counts(lib: Path, op: str = "HMMA") -> dict:
    """{mangled kernel: number of instructions holding ``op``} in ``cuobjdump
    -sass``."""
    return {name: sum(op in ins for _, ins in code) for name, code in _sass(lib).items()}


def k2_build_report() -> None:
    """K2's kernels as built, one line per instantiation (mode: the forward's
    row tile, 4 to 32, or "B > 32"; vec: 16-byte copies): registers, static
    shared memory, stack and spills (the ptxas report); then each mode's
    blocks an SM by CUDA's occupancy calculator. Fails unless all 20 are in
    the build log and the forward's blocks an SM are ``dcor.BLOCKS_PER_SM``,
    the plan the CPU tests emulate."""
    import re

    from repro_torch.kernels import nvcc

    ptxas = _ptxas_report(nvcc.library_path("pairwise_dist").with_suffix(".log").read_text())
    seen = 0
    for mangled, info in sorted(ptxas.items()):
        m = re.search(r"\d(pdist_(?:fwd|bwd))ILi(\d+)ELb([01])E", mangled)
        if m is None:
            continue
        mode = "B > 32" if m.group(2) == "0" else f"tile {m.group(2)}"
        print(f"[build] K2 {m.group(1)}<{mode}, vec {m.group(3)}>: {info['registers']} registers, "
              f"{info['smem']} bytes of static shared memory (+ the 96 KB ring), "
              f"{info['stack']} bytes of stack, spills {info['spill_stores']} / "
              f"{info['spill_loads']} bytes (stores / loads)")
        seen += 1
    if seen != 20:
        fail(f"expected 20 K2 kernels (2 kernels x 5 modes x vec) in the build log, found {seen}")
    import torch

    from repro_torch.kernels import dcor

    dev = torch.device("cuda", torch.cuda.current_device())
    modes = ((4, 4), (8, 8), (16, 16), (32, 32), (70, 2 * dcor.CROSS_TILE))  # (B, rows staged)
    fwd = {B: dcor.blocks_per_sm(dev, B) for B, _ in modes}
    print("[build] K2 blocks an SM (forward / backward): " + ", ".join(
        f"B = {B}: {fwd[B]} / {dcor.blocks_per_sm(dev, B, backward=True)}" for B, _ in modes))
    for B, rows in modes:
        if fwd[B] != dcor.BLOCKS_PER_SM[rows]:
            fail(f"K2 forward at B = {B}: {fwd[B]} blocks an SM, not the "
                 f"{dcor.BLOCKS_PER_SM[rows]} of kernels/dcor.py's BLOCKS_PER_SM")


# the bytes one global load of each width brings
LOAD_BYTES = {"128": 16, "64": 8, "U16": 2, "S16": 2, "U8": 1, "S8": 1}


def _main_loop(code: list, elem_bytes: int) -> dict | None:
    """The loop that streams the row: of the loops (a branch back to an
    earlier address), the one whose body loads the most global bytes, the
    shortest among equals. Its static instructions, the elements its loads
    bring, and its MUFU.EX2, packed bf16 max (HMNMX2, VHMNMX) and global
    loads; None without a loop that loads."""
    import re

    best = None
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m is None or int(m.group(1), 16) > addr:
            continue
        body = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
        # the opcodes of the loads (after any predicate), e.g. LDG.E.128.CONSTANT
        loads = [op for op in (next(w for w in i.split() if not w.startswith("@"))
                               for i in body) if op.startswith("LDG")]
        nbytes = sum(next((LOAD_BYTES[w] for w in op.split(".") if w in LOAD_BYTES), 4)
                     for op in loads)
        key = (nbytes, -len(body))
        if nbytes and (best is None or key > best[0]):
            best = (key, {"instructions": len(body), "elements": nbytes // elem_bytes,
                          "ex2": sum("MUFU.EX2" in i for i in body),
                          "hmnmx": sum("HMNMX" in i for i in body), "loads": len(loads)})
    return None if best is None else best[1]


def k3_build_report() -> None:
    """K3's kernels as built: registers, stack and spills (the ptxas
    report) and the static SASS instructions of each kernel's main loop per
    element it streams (``_main_loop``; a count, not a time: cold branches
    inside the loop count too). Fails if a kernel has a stack frame: a
    register array indexed at run time lives in local memory, 16-byte
    spills in the streaming loop."""
    import re

    from repro_torch.kernels import nvcc

    lib_path = nvcc.library_path("fused_xent")
    ptxas = _ptxas_report(lib_path.with_suffix(".log").read_text())
    for mangled, code in sorted(_sass(lib_path).items()):
        m = re.search(r"(xent_(?:fwd|bwd))I(13__nv_bfloat16|f)(Lb([01])E)?", mangled)
        if m is None:
            continue
        bf16 = m.group(2) != "f"
        kind = f"{m.group(1)}<{'bf16' if bf16 else 'fp32'}" + (
            "" if m.group(4) is None else f", vec {m.group(4)}") + ">"
        info = ptxas.get(mangled, {})
        loop = _main_loop(code, 2 if bf16 else 4)
        text = "no loop that loads" if loop is None else (
            f"main loop {loop['instructions']} instructions for {loop['elements']} elements "
            f"({loop['instructions'] / loop['elements']:.2f} an element; {loop['ex2']} MUFU.EX2, "
            f"{loop['hmnmx']} bf16x2 max, {loop['loads']} global loads)")
        print(f"[build] K3 {kind}: {info.get('registers')} registers, {info.get('stack')} bytes "
              f"of stack, spills {info.get('spill_stores')} / {info.get('spill_loads')} bytes "
              f"(stores / loads), " + text)
        if info.get("stack"):
            fail(f"K3 {kind} has a stack frame of {info['stack']} bytes (local memory)")


def k4_build_report() -> None:
    """K4's kernels as built: registers, shared memory, spills (the ptxas
    report) and HMMA instructions (the SASS). Fails unless every bf16
    kernel (``flash_mma_*``) runs its products on the tensor cores and the
    hd-64 bf16 kernels, the path's, spill nothing."""
    import ctypes
    import re

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc

    lib_path = nvcc.library_path("flash_attention")
    ptxas = _ptxas_report(lib_path.with_suffix(".log").read_text())
    hmma = _hmma_counts(lib_path)
    lib = fa.load_library()
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    kinds = {"fwd": 0, "bwd_dq": 1, "bwd_dkdv": 2}
    seen = 0
    for mangled, info in sorted(ptxas.items()):
        m = re.search(r"\d(flash_(?:mma_)?(fwd|bwd_dq|bwd_dkdv))I(f?)Li(\d+)E", mangled)
        if m is None:
            continue
        name, kind, fp32, hd = m.group(1), m.group(2), m.group(3) == "f", int(m.group(4))
        bf16 = name.startswith("flash_mma_")
        n_hmma = hmma.get(mangled)
        dyn = lib.flash_attention_smem_bytes(kinds[kind], hd, int(bf16))
        print(f"[build] K4 {name}<{'fp32' if fp32 else 'bf16'}, hd {hd}>: "
              f"{info['registers']} registers, {dyn} bytes of (dynamic) shared memory, "
              f"spills {info['spill_stores']} / {info['spill_loads']} bytes (stores / loads), "
              f"{n_hmma} HMMA")
        if bf16 and not n_hmma:
            fail(f"{name}<{hd}> has no HMMA instruction: its products are not on the tensor cores")
        if bf16 and hd == 64 and (info["spill_stores"] or info["spill_loads"]):
            fail(f"{name}<64> spills registers")
        seen += bf16
    if seen != 9:
        fail(f"expected 9 bf16 K4 kernels (3 kernels x hd 32/64/128) in the build log, "
             f"found {seen}")


# K5's kernels; all but prep, bprep and gates run split-TF32 products
MLSTM_KERNELS = ("mlstm_prep", "mlstm_scores", "mlstm_state", "mlstm_out",
                 "mlstm_bprep", "mlstm_bstate", "mlstm_bscores", "mlstm_dq", "mlstm_dv",
                 "mlstm_dk", "mlstm_gates")
MLSTM_SCAN_KERNELS = ("mlstm_prep", "mlstm_bprep", "mlstm_gates")


def k5_build_report() -> None:
    """K5's kernels as built: registers, static shared memory, spills (the
    ptxas report) and TF32 HMMA instructions (the SASS). Fails unless every
    kernel with split-TF32 products has HMMA.1688.F32.TF32 and none of them
    spills (one build serves every dh up to 512)."""
    import re

    from repro_torch.kernels import nvcc

    lib_path = nvcc.library_path("mlstm_chunk")
    ptxas = _ptxas_report(lib_path.with_suffix(".log").read_text())
    hmma = _hmma_counts(lib_path, "HMMA.1688.F32.TF32")
    seen = set()
    for mangled, info in sorted(ptxas.items()):
        m = re.search(r"\d(mlstm_[a-z]+)E", mangled)
        if m is None or m.group(1) not in MLSTM_KERNELS:
            continue
        name, n_hmma = m.group(1), hmma.get(mangled, 0)
        seen.add(name)
        print(f"[build] K5 {name}: {info['registers']} registers, {info['smem']} bytes of shared "
              f"memory, spills {info['spill_stores']} / {info['spill_loads']} bytes (stores / "
              f"loads), {n_hmma} HMMA.1688.F32.TF32")
        if name in MLSTM_SCAN_KERNELS:
            continue
        if not n_hmma:
            fail(f"{name} has no TF32 HMMA instruction: its products are not on the tensor cores")
        if info["spill_stores"] or info["spill_loads"]:
            fail(f"{name} spills registers")
    if seen != set(MLSTM_KERNELS):
        fail(f"K5 kernels missing from the build log: {sorted(set(MLSTM_KERNELS) - seen)}")


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


def _graph_ms_or_none(fn, x):
    """``_graph_ms``, or None where ``fn`` synchronises with the host, which a
    CUDA-graph capture forbids (found before any capture starts, with
    torch's sync debug mode set to raise)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(x)
    except RuntimeError as e:
        print(f"[kernels] not captured in a CUDA graph: {str(e).splitlines()[0]}")
        return None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return _graph_ms(fn, x)


def _ms_text(ms) -> str:
    return "not captured" if ms is None else f"{ms:.4f} ms"


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


def _check_k2(label: str, shape: tuple, g) -> tuple[float, float]:
    """K2 forward and backward at ``shape`` against their plain versions,
    reruns bit-identical; ``label`` "identical rows" makes every row one.
    Returns the max forward and backward |diff|."""
    import torch

    from repro_torch import privacy
    from repro_torch.kernels import dcor
    from repro_torch.kernels.ref import D_MIN, pairwise_dist_bwd_ref, pairwise_dist_ref

    x = torch.randn(shape, generator=g, device="cuda")
    if label == "identical rows":
        x = x[:, :1].expand(shape).contiguous()
    got = dcor.dist_forward(x)
    want = pairwise_dist_ref(x)
    gd = torch.randn(got.shape, generator=g, device="cuda")
    gx = dcor.dist_backward(x, got, gd)
    gx_want = pairwise_dist_bwd_ref(x, got, gd)
    torch.cuda.synchronize()
    if not (torch.equal(dcor.dist_forward(x), got)
            and torch.equal(dcor.dist_backward(x, got, gd), gx)):
        fail(f"pairwise_dist {label} {shape}: a rerun gave other bits")
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
    print(f"[kernels] pairwise_dist {label} {shape}: forward max |diff| {err:.3g} "
          f"(off-diagonal rel {rel:.3g}, plain diagonal max {plain_diag:.3g}), "
          f"backward max |diff| {gerr:.3g}, reruns bit-identical")
    return err, gerr


def phase_k2() -> tuple[float, float]:
    """K2 forward and backward against their plain versions at the dcor
    path's shapes (images 3,072; z of stage 1 up to 65,536), the
    transformers' with dcor (a client's 4 x 512 embedded tokens), a ragged
    shape, B = 1 and a batch of identical rows. Returns the largest
    forward and backward |diff|."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        ("z after stage 1, 5 clients", (5, 32, 65_536)),
        ("z, 16,384", (5, 32, 16_384)),
        ("images, 5 clients", (5, 32, 3_072)),
        ("transformer + dcor, SmolLM-360M", (4, 4, 491_520)),
        ("transformer + dcor, granite-3-2b", (4, 4, 1_048_576)),
        ("B = 8", (3, 8, 10_000)),
        ("ragged", (3, 17, 1_001)),
        ("ragged, B > 32", (2, 70, 4_100)),
        ("B = 1", (2, 1, 100)),
        ("identical rows", (2, 32, 3_072)),
    ]
    fwd_err = bwd_err = 0.0
    for label, shape in cases:
        err, gerr = _check_k2(label, shape, g)
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
    return fwd_err, bwd_err


def phase_k2_times(fwd_err: float, bwd_err: float) -> list[dict]:
    """K2's times at (5, 32, 65,536) and (5, 32, 3,072), the dcor path's,
    and at (4, 4, 491,520) and (4, 4, 1,048,576), SmolLM-360M's and
    granite-3-2b's with dcor: CUDA events and
    CUDA-graph device time for the kernels, their plain versions and the
    library yardsticks. Run after the training runs, so the graphs' memory
    pools stay out of their peak memory."""
    import torch

    from repro_torch.kernels import dcor
    from repro_torch.kernels.ref import pairwise_dist_bwd_ref, pairwise_dist_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    entries = []
    for shape in ((5, 32, 65_536), (5, 32, 3_072), (4, 4, 491_520), (4, 4, 1_048_576)):
        C, B, F = shape
        x = torch.randn(shape, generator=g, device="cuda")
        dist = dcor.dist_forward(x)
        gd = torch.randn(dist.shape, generator=g, device="cuda")
        xr = x.clone().requires_grad_(True)
        fwd_fn = dcor.dist_forward
        bwd_fn = partial(dcor.dist_backward, dist=dist, g_dist=gd)
        fwd_plain = pairwise_dist_ref
        bwd_plain = partial(pairwise_dist_bwd_ref, dist=dist, g_dist=gd)
        # yardsticks only (timed here, never called by the port): torch.cdist,
        # and its forward + backward for the backward
        fwd_lib = lambda t: torch.cdist(t, t)                         # noqa: E731
        bwd_lib = lambda t: torch.autograd.grad(torch.cdist(t, t), t, gd)  # noqa: E731
        fwd = {"ms": _cuda_ms(fwd_fn, x), "plain_ms": _cuda_ms(fwd_plain, x),
               "library_ms": _cuda_ms(fwd_lib, x),
               "device_ms": _graph_ms(fwd_fn, x), "plain_device_ms": _graph_ms(fwd_plain, x),
               "library_device_ms": _graph_ms_or_none(fwd_lib, x)}
        bwd = {"ms": _cuda_ms(bwd_fn, x), "plain_ms": _cuda_ms(bwd_plain, x),
               "library_ms": _cuda_ms(bwd_lib, xr),
               "device_ms": _graph_ms(bwd_fn, x), "plain_device_ms": _graph_ms(bwd_plain, x),
               "library_device_ms": _graph_ms_or_none(bwd_lib, xr)}
        gram_ops = C * B * (B + 1) * F   # B (B + 1) / 2 entries i <= j, an FMA each a column
        fwd["bound_ms"], fwd["bound_by"] = _bound(4 * (C * B * F + C * B * B),
                                                  gram_ops + 6 * C * B * B)
        bwd["bound_ms"], bwd["bound_by"] = _bound(4 * (2 * C * B * F + 2 * C * B * B),
                                                  2 * C * B * B * F + 8 * C * B * B)
        for name, t in (("forward", fwd), ("backward", bwd)):
            print(f"[kernels] pairwise_dist {name} at {shape} fp32: kernel {t['ms']:.4f} ms "
                  f"(device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms "
                  f"(device {t['plain_device_ms']:.4f} ms), library {t['library_ms']:.4f} ms "
                  f"(device {_ms_text(t['library_device_ms'])}), "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                  f"{100 * t['bound_ms'] / t['device_ms']:.1f}% of it on device time")
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


def phase_main_path() -> tuple[int, float]:
    import torch

    from repro_torch.kernels import fused_xent, quantize
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
    fused_xent.LAUNCHES.update(forward=0, backward=0)
    fused_xent.SHAPES.clear()
    logs = train.main(argv, on_round=on_round)
    launches = quantize.LAUNCHES
    k3 = dict(fused_xent.LAUNCHES)
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
          f"(torch.cuda.max_memory_allocated), int8_roundtrip launches {launches}, "
          f"fused_xent launches forward {k3['forward']} backward {k3['backward']}")
    _check_k3_launched("main path")
    return launches, logs[-1].clock


def phase_dcor_run() -> tuple[int, int]:
    """Table 5's data with the dcor regularizer at full width; every round
    must launch the K2 forward and backward kernels."""
    import torch

    from repro_torch.kernels import dcor, fused_xent
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
    fused_xent.SHAPES.clear()
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
    _check_k3_launched("dcor run")
    return launches["forward"], launches["backward"]


def _kernel_totals(prof) -> dict:
    """{name: [calls, device seconds]} of the traced device activities
    (kernels, copies, sets), read from the raw trace: ``key_averages``
    builds a Python object per event and takes minutes on the ~10^6 events
    of the xLSTM rounds. A kernel launched through ctypes is traced like
    any other."""
    from torch.autograd import DeviceType

    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t = totals.setdefault(e.name(), [0, 0.0])
            t[0] += 1
            t[1] += e.duration_ns() / 1e9
    return totals


def _named(totals: dict, names) -> tuple[int, float]:
    """Calls and device seconds of the activities whose name holds one of ``names``."""
    hits = [v for key, v in totals.items() if any(n in key for n in names)]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def _profile(fn):
    """Run ``fn()`` under torch.profiler with device activity only (the one
    setting of every profile here); returns (fn's result, kernel totals)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, _kernel_totals(prof)


K2_KERNELS = ("pdist_fwd", "pdist_bwd")
K3_KERNELS = ("xent_fwd", "xent_bwd")
K4_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",       # fp32
              "flash_mma_fwd", "flash_mma_bwd_dq", "flash_mma_bwd_dkdv")  # bf16


def phase_k2_profile() -> None:
    """torch.profiler over K2's kernels at the dcor path's largest shape and
    at a transformer's: device time per call. Printed only; a trace with no
    device time prints "not measured"."""
    import torch

    from repro_torch.kernels import dcor

    g = torch.Generator(device="cuda").manual_seed(2)
    for shape in ((5, 32, 65_536), (4, 4, 491_520)):
        x = torch.randn(shape, generator=g, device="cuda")
        dist = dcor.dist_forward(x)
        gd = torch.randn(dist.shape, generator=g, device="cuda")
        torch.cuda.synchronize()

        def calls():
            for _ in range(TIMED_ITERS):
                dcor.dist_forward(x)
                dcor.dist_backward(x, dist, gd)
            torch.cuda.synchronize()

        _, totals = _profile(calls)
        for name in K2_KERNELS:
            us = _named(totals, (name,))[1] * 1e6 / TIMED_ITERS
            print(f"[profile] K2 {name} at {shape}: "
                  + (f"{us / 1e3:.4f} ms device time per call" if us else "not measured"))


def phase_rounds_profile(label: str, argv: list[str], groups: dict) -> None:
    """torch.profiler over two rounds of the CLI run ``argv``, its trainer
    (and the initial weights' copy to the card) built outside the trace: the
    device busy share, each kernel group's share and its kernels' calls, the
    top kernels. Printed only."""
    import gc

    import torch

    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()
    trainer, eval_batch = train.build(train.build_parser().parse_args(argv))
    logs, totals = _profile(lambda: trainer.run(2, eval_batch))
    busy = sum(t for _, t in totals.values())
    if not busy:
        print(f"[profile] {label}: no device time in the trace (not measured)")
        return
    wall = sum(log.wall_s for log in logs)
    shares = ", ".join(f"{g} {_named(totals, names)[1]:.4f} s "
                       f"({_named(totals, names)[1] / busy:.2%} of device time)"
                       for g, names in groups.items())
    print(f"[profile] {label}, rounds 0-1 under the profiler: wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({busy / wall:.1%} of wall), {shares}, "
          f"{sum(n for n, _ in totals.values())} device activities")
    for name in (name for names in groups.values() for name in names):
        n, t = _named(totals, (name,))
        print(f"[profile]   {name}: {n} calls, {t:.4f} s"
              + (f", {t / n * 1e3:.4f} ms per call" if n else ""))
    for key, (n, t) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[profile]   {t:.4f} s  {n:6d} x  {key[:90]}")


DCOR_PROFILE_ARGV = ["--arch", "resnet-56", "--full-size", "--dataset", "cifar10-noisy",
                     "--clients", "5", "--samples", "1200", "--iid", "--batch-size", "32",
                     "--dcor-alpha", "0.5", "--scheduler", "dynamic", "--lr", "1e-3",
                     "--device", "cuda"]


RESNET_SMALL = ["--arch", "resnet-56", "--clients", "4", "--samples", "200",
                "--batch-size", "16", "--rounds", "3"]
SMOLLM_SMALL = ["--arch", "smollm-360m", "--clients", "4", "--batch-size", "4",
                "--seq-len", "64", "--rounds", "3"]


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """The '/'-joined key paths of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def phase_small_reference(argv: list[str], label: str,
                          bounds: tuple[float, float, float] = (0.5, 0.1, 0.01)):
    """The CLI at a tiny size on the card against the CPU's plain path;
    parameters within ``bounds`` (max, 99th percentile, median) in units of
    lr * local steps. Returns the card's and the CPU's trainers."""
    import numpy as np

    from repro_torch.bridge import to_numpy_tree
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    runs, plans = {}, {}
    for device in ("cuda", "cpu"):
        got = {}
        with _baseline_plans() as plans[device]:
            logs = train.main(argv + ["--device", device],
                              on_round=lambda tr, log: got.update(trainer=tr))
        runs[device] = (logs, got["trainer"])
    (glogs, gtr), (clogs, ctr) = runs["cuda"], runs["cpu"]
    for a, b in zip(glogs, clogs):
        if ((a.clock, a.assignment, a.uplink_bytes, a.hosts)
                != (b.clock, b.assignment, b.uplink_bytes, b.hosts)):
            fail(f"{label} round {a.round}: clock/assignment/uplink/hosts differ between "
                 f"card and CPU")
    # a baseline's selections (the rounds engine logs none)
    if plans["cuda"] != plans["cpu"]:
        fail(f"{label}: the trained clients differ between card and CPU")
    # the bounds of tests/test_torch_dtfl.py, in units of lr * local steps
    # (one round's a log: an async run's wave 0 and merges are a chain)
    sampled = set().union(*(log.assignment for log in clogs)) or range(len(ctr.clients))
    unit = 1e-3 * len(clogs) * max(ctr.clients[k].n_batches for k in sampled)
    names = _leaf_names(ctr.params)
    diffs = [np.abs(x - y) for x, y in zip(
        tree_leaves(to_numpy_tree(gtr.params)), tree_leaves(to_numpy_tree(ctr.params)))]
    d = np.concatenate([x.ravel() for x in diffs])
    p99 = np.quantile(d, 0.99)
    print(f"[reference] card vs CPU, reduced {argv[1]}, {len(clogs)} {label} rounds: logs equal, "
          f"parameter |diff| max {d.max():.3g} ({d.max() / unit:.3g} U) median "
          f"{np.median(d):.3g} ({np.median(d) / unit:.3g} U), 99th percentile "
          f"{p99 / unit:.3g} U")
    above = sorted(((int((x > p99).sum()), n) for n, x in zip(names, diffs)), reverse=True)
    print("[reference]   elements above the 99th percentile, by leaf: "
          + ", ".join(f"{n} {c}" for c, n in above[:5]))
    if d.max() > bounds[0] * unit or p99 > bounds[1] * unit or np.median(d) > bounds[2] * unit:
        fail(f"{label}: card and CPU parameters differ: max {d.max() / unit} U, "
             f"99th percentile {p99 / unit} U, median {np.median(d) / unit} U")
    return gtr, ctr


POPULATION_ARGV = ["--arch", "resnet-56", "--full-size", "--population", "100000",
                   "--sample-size", "64", "--samples", "64", "--batch-size", "32",
                   "--exec", "chunked", "--chunk-size", "16", "--codec", "topk0.05",
                   "--rounds", "3", "--device", "cuda"]
PAIRING_ARGV = ["--arch", "resnet-56", "--full-size", "--clients", "8", "--samples", "1600",
                "--topology", "pairing", "--exec", "loop", "--codec", "int8", "--rounds", "3",
                "--device", "cuda"]
EVENTS_ARGV = ["--arch", "resnet-56", "--full-size", "--clients", "10", "--samples", "2000",
               "--engine", "events", "--churn", "--codec", "topk0.05", "--rounds", "3",
               "--device", "cuda"]
K1_KERNELS = ("absmax_rows", "qdq_rows")


def _wire_check(label: str, trainer, log) -> None:
    """A round's uplink bytes must be ``wire_sizes``' own count for its
    participants' tiers and batch counts, from a table built anew."""
    import numpy as np

    from repro_torch.core.codec import wire_sizes

    ks = sorted(log.assignment)
    want = float(wire_sizes(trainer.costs, trainer.codec.name).uplink_bytes(
        np.array([log.assignment[k] for k in ks]),
        np.array([trainer.clients[k].n_batches for k in ks])).sum())
    if log.uplink_bytes != want:
        fail(f"{label} round {log.round}: uplink bytes {log.uplink_bytes} differ from "
             f"wire_sizes' {want}")


class _SentCount:
    """Counts what a top-k codec really sends: wraps the trainer's
    ``codec.rt`` (every activation uplink and every update upload goes
    through it) and adds up, on the device, the rows whose non-zero count
    exceeds k = ceil(frac * n), the rows with exactly k, and all rows.
    ``wire_sizes`` prices k entries a row, so a row above k is a codec
    that sends more than it is priced for."""

    def __init__(self):
        self.trainer = None
        self.calls = 0

    def install(self, trainer) -> None:
        import torch

        if self.trainer is not None:
            return
        self.trainer, codec, inner = trainer, trainer.codec, trainer.codec.rt
        self.over, self.full, self.rows = (
            torch.zeros((), dtype=torch.int64, device=trainer.device) for _ in range(3))

        def rt(x):
            out = inner(x)
            if out.is_floating_point():
                rows = out.reshape(out.shape[0], -1)
                nnz = torch.count_nonzero(rows, dim=1)
                k = codec._k(rows.shape[1])
                self.over += (nnz > k).sum()
                self.full += (nnz == k).sum()
                self.rows += rows.shape[0]
                self.calls += 1
            return out

        codec.rt = rt

    def check(self, label: str) -> None:
        over, full, rows = int(self.over), int(self.full), int(self.rows)
        print(f"[{label}] top-k rows sent after round 0: {rows} in {self.calls} calls, "
              f"{full} with exactly k non-zero entries, {over} with more")
        if not self.calls or over or not full:
            fail(f"{label}: {over} of {rows} sent rows hold more than k non-zero entries "
                 f"({full} exactly k, {self.calls} calls)")


def phase_population_run() -> None:
    """The population plane at full width: 64 of 100,000 lazily registered
    clients a round, trained 16 at a time (the chunked plane), top-k
    uploads with error feedback whose residuals live in host memory. A
    client is sampled at most once in 3 rounds here, so every residual
    sent to the device is a fresh zero and none is read back."""
    import torch

    from repro_torch.launch import train

    rounds, shapes, sent = [], {}, _SentCount()

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        _wire_check("population run", trainer, log)
        sent.install(trainer)
        rounds.append((log, trainer.clients.n_touched, len(trainer._ef), trainer.ef_copy_s))

    torch.cuda.reset_peak_memory_stats()
    logs = train.main(POPULATION_ARGV, on_round=on_round)
    peak = torch.cuda.max_memory_allocated()
    if len(logs) != 3:
        fail(f"population run: expected 3 rounds, got {len(logs)}")
    sent.check("population")
    sampled, copied = set(), 0.0
    for log, touched, n_ef, copy_s in rounds:
        reused = len(sampled & set(log.assignment))
        sampled |= set(log.assignment)
        # the trainer reads client 0's batch size when it is built
        if touched > len(sampled | {0}):
            fail(f"population run round {log.round}: {touched} clients touched, "
                 f"{len(sampled)} sampled so far")
        if n_ef != len(sampled):
            fail(f"population run round {log.round}: {n_ef} clients hold residuals, "
                 f"{len(sampled)} were sampled")
        print(f"[population] round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, tiers {sorted(set(log.assignment.values()))}, "
              f"uplink_bytes {log.uplink_bytes:.0f}, clients touched {touched}, "
              f"holding residuals {n_ef}, sampled again {reused}, residual gather + "
              f"scatter {copy_s - copied:.4f} s ({(copy_s - copied) / log.wall_s:.1%} of "
              f"the round's wall)")
        copied = copy_s
    print(f"[population] peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")


def _k1_device_ms_by_round(prof, per_round: list[int]) -> list:
    """Device ms of the K1 kernels of each round, from the trace's kernels
    in start order, split by the launch counts of ``per_round``; None where
    the trace holds a different number of K1 kernels."""
    from torch.autograd import DeviceType

    evs = sorted((e.start_ns(), e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and any(n in e.name() for n in K1_KERNELS))
    if len(evs) != sum(per_round):
        return [None] * len(per_round)
    out, i = [], 0
    for n in per_round:
        out.append(sum(d for _, d in evs[i:i + n]) / 1e6)
        i += n
    return out


def _pairing_loop_rounds(traced: bool):
    """The pairing loop run; returns its logs with the K1 launches of each
    round, and the profiler when ``traced``."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import quantize
    from repro_torch.launch import train

    rounds, shapes = [], {}

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        rounds.append((log, quantize.LAUNCHES))

    quantize.LAUNCHES = 0
    with (profile(activities=[ProfilerActivity.CUDA]) if traced else nullcontext()) as prof:
        logs = train.main(PAIRING_ARGV, on_round=on_round)
    if len(logs) != 3:
        fail(f"pairing loop run: expected 3 rounds, got {len(logs)}")
    per_round, before = [], 0
    for log, count in rounds:
        if count <= before:
            fail(f"pairing loop run round {log.round} launched no int8_roundtrip kernel")
        per_round.append(count - before)
        before = count
    return [log for log, _ in rounds], per_round, prof


def phase_pairing_loop_run() -> None:
    """Pairing topology on the loop plane with the int8 codec: every
    single-client upload goes through K1 one leaf at a time; every round
    must launch it. Run twice with the same flags: untraced for the walls,
    then with device activity traced for K1's device time and the device's
    busy time (the sum of every traced kernel, copy and set)."""
    logs, per_round, _ = _pairing_loop_rounds(traced=False)
    tlogs, tper_round, prof = _pairing_loop_rounds(traced=True)
    if [(l.clock, l.assignment, l.hosts) for l in logs] != \
            [(l.clock, l.assignment, l.hosts) for l in tlogs] or per_round != tper_round:
        fail("pairing loop run: the traced run differs from the untraced one")
    device_ms = _k1_device_ms_by_round(prof, per_round)
    for log, tlog, n, ms in zip(logs, tlogs, per_round, device_ms):
        print(f"[pairing] round {log.round}: wall {log.wall_s:.3f} s untraced "
              f"({tlog.wall_s:.3f} s traced), sim clock {log.clock:.4f} s, tiers "
              f"{sorted(set(log.assignment.values()))}, hosts {log.hosts}, uplink_bytes "
              f"{log.uplink_bytes:.0f}, int8_roundtrip launches {n}, their device time "
              + ("not measured" if ms is None else f"{ms:.4f} ms ({ms / n * 1e3:.2f} us a launch)"))
    busy = sum(t for _, t in _kernel_totals(prof).values())
    wall = sum(log.wall_s for log in logs)
    print(f"[pairing] device busy {busy:.3f} s over the 3 traced rounds against "
          f"{wall:.3f} s of untraced wall: idle share {1 - busy / wall:.1%}")
    if not any(log.hosts for log in logs):
        print("[pairing] no round had a peer host")


def phase_events_run() -> None:
    """The events engine with churn at full width, top-k uploads."""
    from repro_torch.launch import train

    shapes, rounds, sent = {}, [], _SentCount()

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        _wire_check("events run", trainer, log)
        sent.install(trainer)
        rounds.append((log, len(trainer._ef)))

    logs = train.main(EVENTS_ARGV, on_round=on_round)
    if len(logs) != 3:
        fail(f"events run: expected 3 rounds, got {len(logs)}")
    sent.check("events")
    for log, n_ef in rounds:
        print(f"[events] round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, straggler {log.straggler:.4f} s, tiers "
              f"{sorted(set(log.assignment.values()))}, uplink_bytes {log.uplink_bytes:.0f}, "
              f"clients holding residuals {n_ef}")


RESUME_ARGV = ["--arch", "resnet-56", "--full-size", "--clients", "10", "--samples", "2000",
               "--codec", "topk0.05", "--device", "cuda"]
ASYNC_ARGV = ["--arch", "resnet-56", "--full-size", "--clients", "10", "--samples", "2000",
              "--engine", "async", "--n-groups", "3", "--rounds", "3", "--codec", "int8",
              "--device", "cuda"]
MICRO_SMALL = ["--arch", "resnet-micro", "--clients", "6", "--samples", "300",
               "--batch-size", "16"]
# phase 19's tier-0 bound, the tightest the smoke holds two card runs to
RESUME_TIGHT_U = 0.001


def _keyed(trainer) -> dict:
    """The trainer's parameters, aux heads and residuals as host arrays,
    keyed by their envelope paths."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.bridge import to_numpy_tree

    ef = {str(c): {"c": st["c"], "a": st["a"]} for c, st in trainer._ef.items()}
    return ckpt._flatten(to_numpy_tree({"params": trainer.params,
                                        "aux": {str(m): a for m, a in trainer.aux.items()},
                                        "ef": ef}))


def _resume_runs(argv: list[str], directory: str):
    """(a) 4 rounds, (b) 2 rounds writing an envelope, (c) 4 rounds resumed
    from it; returns (a)'s and (c)'s logs and trainers, and the envelope."""
    import os

    from repro_torch.launch import train

    path = os.path.join(directory, "state.npz")
    runs = []
    for extra in (["--rounds", "4"], ["--rounds", "2", "--out-ckpt", path, "--save-every", "2"],
                  ["--rounds", "4", "--resume", path]):
        got = {}
        logs = train.main(argv + extra, on_round=lambda tr, log: got.update(trainer=tr))
        runs.append((logs, got["trainer"]))
    (alogs, atr), (blogs, _), (clogs, ctr) = runs
    if [log.round for log in blogs] != [0, 1] or [log.round for log in clogs] != [2, 3]:
        fail(f"resume: rounds {[l.round for l in blogs]} then {[l.round for l in clogs]}")
    return alogs, atr, clogs, ctr, path


def phase_resume_run() -> None:
    """Save at round 2, resume, and hold rounds 2-3 to the uninterrupted run."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import checkpoint as ckpt
    from repro_torch.fed import engine

    timed = {"save": [], "load": []}
    save, resume = engine.save_train_state, engine.apply_resume

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        save(*a, **kw)
        timed["save"].append(time.perf_counter() - t0)

    def timed_resume(*a, **kw):
        t0 = time.perf_counter()
        out = resume(*a, **kw)
        timed["load"].append(time.perf_counter() - t0)
        return out

    engine.save_train_state, engine.apply_resume = timed_save, timed_resume
    directory = tempfile.mkdtemp(prefix=".smoke_resume_", dir=ROOT)
    try:
        alogs, atr, clogs, ctr, path = _resume_runs(RESUME_ARGV, directory)
        t0 = time.perf_counter()
        env = ckpt.load(path)
        read_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        engine.save_train_state, engine.apply_resume = save, resume
        shutil.rmtree(directory, ignore_errors=True)
    holders = sorted(int(c) for c in env["trainer"].get("ef", {}))
    print(f"[resume] envelope {size} bytes, {len(holders)} clients' residuals in it "
          f"({holders}); save {timed['save'][0]:.4f} s host (state to the host + npz "
          f"write), load {timed['load'][0]:.4f} s host (the trainer's state onto the card; "
          f"reading the file {read_s:.4f} s)")
    for a, c in zip(alogs[2:], clogs):
        if (a.clock, a.assignment, a.uplink_bytes, a.acc, a.straggler) != \
                (c.clock, c.assignment, c.uplink_bytes, c.acc, c.straggler):
            fail(f"resume round {c.round}: clock/tiers/uplink/acc differ from the "
                 f"uninterrupted run")
        print(f"[resume] round {c.round}: wall {c.wall_s:.3f} s (uninterrupted "
              f"{a.wall_s:.3f} s), sim clock {c.clock:.4f} s, tiers "
              f"{sorted(set(c.assignment.values()))}, uplink_bytes {c.uplink_bytes:.0f}, "
              f"acc {c.acc:.4f}: equal")
    want, got = _keyed(atr), _keyed(ctr)
    if sorted(want) != sorted(got) or sorted(atr._ef) != sorted(ctr._ef):
        fail("resume: the resumed run holds other leaves or residuals")
    unit = 1e-3 * 4 * max(atr.clients[k].n_batches for k in alogs[-1].assignment)
    diffs = {k: float(np.abs(want[k].astype(np.float64) - got[k]).max()) if want[k].size
             else 0.0 for k in want}
    worst = max(diffs, key=diffs.get)
    n_unequal = sum(not np.array_equal(want[k], got[k]) for k in want)
    print(f"[resume] parameters, aux heads and residuals against the uninterrupted run: "
          + ("bit-equal" if not n_unequal else
             f"{n_unequal} of {len(want)} leaves not bit-equal, largest difference "
             f"{diffs[worst]:.3g} ({diffs[worst] / unit:.3g} U) in {worst}"))
    if diffs[worst] > RESUME_TIGHT_U * unit:
        fail(f"resume: {worst} apart by {diffs[worst] / unit} U, bound {RESUME_TIGHT_U} U")


def phase_async_run() -> None:
    """The async engine at full width with int8 uploads (K1 on every wave)."""
    import torch

    from repro_torch.kernels import quantize
    from repro_torch.launch import train

    merges, shapes, rec = [], {}, {"groups": None, "members": []}

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
            groups, train_group = trainer.async_groups, trainer.train_group

            def async_groups(cids, n):
                rec["groups"] = groups(cids, n)
                return rec["groups"]

            def train(r, plan, trained):
                rec["members"].append(list(trained))
                return train_group(r, plan, trained)

            trainer.async_groups, trainer.train_group = async_groups, train
        else:
            _check_trees_finite(trainer, shapes)
        merges.append((log, quantize.LAUNCHES))

    torch.cuda.reset_peak_memory_stats()
    quantize.LAUNCHES = 0
    logs = train.main(ASYNC_ARGV, on_round=on_round)
    peak = torch.cuda.max_memory_allocated()
    if len(logs) != 10 or len(rec["members"]) != 9:
        fail(f"async run: expected wave 0 and 9 merges, got {len(logs)} logs")
    clocks = [log.clock for log in logs]
    if clocks != sorted(clocks):
        fail("async run: the merge clocks go backwards")
    print(f"[async] speed groups {rec['groups']}")
    before = 0
    for i, (log, count) in enumerate(merges):
        if count <= before:
            fail(f"async run log {log.round} launched no int8_roundtrip kernel")
        what = ("wave 0 (all clients)" if i == 0 else
                f"merge {log.round}, group "
                f"{next(g for g, m in enumerate(rec['groups']) if rec['members'][i - 1][0] in m)}"
                f" ({len(rec['members'][i - 1])} clients)")
        print(f"[async] {what}: sim clock {log.clock:.4f} s, wave {log.straggler:.4f} s, "
              f"wall {log.wall_s:.3f} s, tiers {sorted(set(log.assignment.values()))}, "
              f"acc {log.acc:.4f}, int8_roundtrip launches {count - before}")
        before = count
    print(f"[async] peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), int8_roundtrip launches {before}")


BASELINE_ARGV = ["--arch", "resnet-56", "--full-size", "--clients", "10", "--samples", "2000",
                 "--batch-size", "32", "--rounds", "3", "--lr", "1e-3", "--device", "cuda"]
BASELINE_RUNS = {
    "fedavg": ["--codec", "int8"], "fedyogi": ["--codec", "int8"],
    "tifl": ["--codec", "int8"], "drop30": ["--codec", "int8"],
    "splitfed": [], "fedgkt": [],
    "fedat": ["--engine", "async", "--n-groups", "3", "--codec", "int8"],
}


@contextmanager
def _baseline_plans():
    """Record every baseline plan's trained clients, in order (the rounds
    engine logs a baseline's round without them), and with them the
    trained list whose bytes the next log reports."""
    from repro_torch.fed.base import BaseTrainer

    real = BaseTrainer.plan_round
    planned: list[list[int]] = []

    def plan_round(self, r, participants):
        plan = real(self, r, participants)
        planned.append(list(plan.trained))
        return plan

    BaseTrainer.plan_round = plan_round
    try:
        yield planned
    finally:
        BaseTrainer.plan_round = real


def phase_baselines_run(dtfl_clock: float) -> None:
    """The seven full-model baselines at full width through the CLI, K1 on
    every int8 wire, K3 on every loss; FedAvg's simulated clock over DTFL's
    (the main path's) printed last."""
    import gc

    import torch

    from repro_torch.core.codec import wire_sizes
    from repro_torch.kernels import fused_xent, quantize
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    clocks = {}
    fused_xent.SHAPES.clear()
    for method, extra in BASELINE_RUNS.items():
        rows, got, members = [], {}, []

        def on_round(trainer, log):
            got["trainer"] = trainer
            rows.append((log, quantize.LAUNCHES, dict(fused_xent.LAUNCHES),
                         list(planned[-1]), list(members[-1]) if members else None))

        # this run's own peak: the blocks the previous run cached are released
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _baseline_plans() as planned:
            if method == "fedat":      # the merged group's members, a merge each
                from repro_torch.fed.base import BaseTrainer

                real = BaseTrainer.train_group
                BaseTrainer.train_group = lambda self, r, plan, trained: (
                    members.append(list(trained)) or real(self, r, plan, trained))
            quantize.LAUNCHES = 0
            fused_xent.LAUNCHES.update(forward=0, backward=0)
            try:
                logs = train.main(BASELINE_ARGV + ["--method", method] + extra,
                                  on_round=on_round)
            finally:
                if method == "fedat":
                    BaseTrainer.train_group = real
        peak = torch.cuda.max_memory_reserved(), torch.cuda.max_memory_allocated()
        tr = got["trainer"]
        want_logs = 1 + 3 * 3 if method == "fedat" else 3
        if len(logs) != want_logs or len(rows) != want_logs:
            fail(f"{method} run: expected {want_logs} logs, got {len(logs)}")
        full_up = wire_sizes(tr.costs, tr.codec.name).full_up
        before, xent = 0, {"forward": 0, "backward": 0}
        for log, k1, k3, last_plan, group in rows:
            k3_new = {k: k3[k] - xent[k] for k in k3}
            if log.uplink_bytes != full_up * len(last_plan):
                fail(f"{method} log {log.round}: uplink bytes {log.uplink_bytes} differ from "
                     f"full_up x {len(last_plan)} trained = {full_up * len(last_plan)}")
            if tr.codec.name == "int8" and k1 <= before:
                fail(f"{method} log {log.round} launched no int8_roundtrip kernel")
            if min(k3_new.values()) <= 0:
                fail(f"{method} log {log.round} launched no fused_xent forward or backward")
            trained = group if group is not None and log.round > 0 else last_plan
            print(f"[baselines] {method} {'merge' if method == 'fedat' else 'round'} "
                  f"{log.round}: wall {log.wall_s:.3f} s, sim clock {log.clock:.4f} s, "
                  f"trained {trained}, uplink_bytes {log.uplink_bytes:.0f}, acc {log.acc:.4f}, "
                  f"int8_roundtrip launches {k1 - before}, fused_xent launches forward "
                  f"{k3_new['forward']} backward {k3_new['backward']}")
            before, xent = k1, k3
        # every tree finite, and shaped as a fresh init of the model (and, for
        # FedGKT, of its split at md2 and of its aux head)
        gen = torch.Generator().manual_seed(0)
        trees, fresh = {"params": tr.params}, {"params": tr.adapter.init_global(gen)}
        if method == "fedgkt":
            trees.update(edge=tr.client_params, server=tr.server_params, aux=tr.aux)
            fresh["edge"], fresh["server"] = tr.adapter.split(fresh["params"], 1)
            fresh["aux"] = tr.adapter.aux_init(gen, 1)
        shaped = lambda tree: dict(zip(_leaf_names(tree), (t.shape for t in tree_leaves(tree))))
        for name, tree in trees.items():
            if shaped(tree) != shaped(fresh[name]):
                fail(f"{method} run: the shapes of {name} changed")
            if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)):
                fail(f"{method} run: non-finite values in {name}")
        clocks[method] = logs[-1].clock
        print(f"[baselines] {method}: peak reserved {peak[0] / 2**30:.3f} GiB "
              f"(allocated {peak[1] / 2**30:.3f} GiB), "
              f"int8_roundtrip launches {before}, fused_xent launches forward "
              f"{xent['forward']} backward {xent['backward']}, every tree finite")
    print(f"[baselines] simulated clock after 3 rounds, FedAvg over DTFL (the main path): "
          f"{clocks['fedavg']:.4f} / {dtfl_clock:.4f} s = {clocks['fedavg'] / dtfl_clock:.3f}x")
    del tr, got
    gc.collect()
    torch.cuda.empty_cache()
    _check_k3_launched("baselines run")


def phase_resume_reference() -> None:
    """The resume of phase 20 at ``resnet-micro`` with top-k, on the card
    and on the CPU: the resumed rounds' logs equal, parameters close."""
    import shutil
    import tempfile

    import numpy as np

    runs = {}
    for device in ("cuda", "cpu"):
        directory = tempfile.mkdtemp(prefix=".smoke_resume_", dir=ROOT)
        try:
            runs[device] = _resume_runs(MICRO_SMALL + ["--codec", "topk0.05", "--device",
                                                       device], directory)
        finally:
            shutil.rmtree(directory, ignore_errors=True)
    (_, _, glogs, gtr, _), (_, _, clogs, ctr, _) = runs["cuda"], runs["cpu"]
    for a, b in zip(glogs, clogs):
        if (a.clock, a.assignment, a.uplink_bytes) != (b.clock, b.assignment, b.uplink_bytes):
            fail(f"resume reference round {a.round}: clock/assignment/uplink differ between "
                 "card and CPU")
    unit = 1e-3 * 4 * max(ctr.clients[k].n_batches for k in clogs[-1].assignment)
    g, c = _keyed(gtr), _keyed(ctr)
    d = np.concatenate([np.abs(g[k] - c[k]).ravel() for k in sorted(c) if k.startswith("d:params")])
    stats = (d.max() / unit, np.quantile(d, 0.99) / unit, np.median(d) / unit)
    print(f"[reference] card vs CPU, resnet-micro, top-k, rounds 2-3 resumed from round 2: "
          f"logs equal, parameters {stats[0]:.3g} / {stats[1]:.3g} / {stats[2]:.3g} U (max, "
          f"99th percentile, median)")
    if any(x > b for x, b in zip(stats, (0.5, 0.1, 0.01))):
        fail(f"resume reference: card and CPU parameters apart by {stats} U")


def _u_stats(pairs, unit: float) -> tuple[float, float, float]:
    """(max, 99th percentile, median) of |x - y| over ``pairs``, in U."""
    import numpy as np

    d = np.concatenate([np.abs(x - y).ravel() for x, y in pairs])
    return d.max() / unit, np.quantile(d, 0.99) / unit, np.median(d) / unit


# tests/test_torch_planes.py's bounds, in U: parameters; aux heads and
# residuals; the share of residual entries zero on one side only
PLANE_BOUNDS, EF_BOUNDS, EF_FLIPS = (0.5, 0.1, 0.01), (0.5, 0.2, 0.01), 0.05


def phase_chunked_vs_cohort(argv: list[str], label: str, tight: float | None = None) -> None:
    """The same small run on the chunked and the cohort plane, on the card:
    logs must be equal, residuals held by the same clients at the same
    tiers. The parameters, aux heads and residuals are held to
    ``tests/test_torch_planes.py``'s bounds, or, with ``tight``, every one
    of them to a max of ``tight`` U. Prints whether they are bit-equal."""
    import numpy as np

    from repro_torch.bridge import to_numpy_tree
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    runs = {}
    for plane in (["--exec", "cohort"], ["--exec", "chunked", "--chunk-size", "2"]):
        got = {}
        logs = train.main(argv + plane + ["--device", "cuda"],
                          on_round=lambda tr, log: got.update(trainer=tr))
        runs[plane[1]] = (logs, got["trainer"])
    (alogs, atr), (blogs, btr) = runs["cohort"], runs["chunked"]
    for a, b in zip(alogs, blogs):
        if (a.clock, a.assignment, a.uplink_bytes) != (b.clock, b.assignment, b.uplink_bytes):
            fail(f"chunked vs cohort round {a.round}: clock/assignment/uplink differ")
    if {c: st["tier"] for c, st in atr._ef.items()} != {c: st["tier"] for c, st in btr._ef.items()}:
        fail(f"chunked vs cohort, {label}: residuals held by other clients or tiers")
    pairs = lambda ta, tb: list(zip(tree_leaves(to_numpy_tree(ta)), tree_leaves(to_numpy_tree(tb))))
    unit = 1e-3 * 3 * max(atr.clients[k].n_batches
                          for k in set().union(*(log.assignment for log in alogs)))
    groups = [("parameters", pairs(atr.params, btr.params), PLANE_BOUNDS)]
    groups += [(f"aux {m}", pairs(atr.aux[m], btr.aux[m]), EF_BOUNDS) for m in sorted(atr.aux)]
    groups += [(f"residual {c}{k}", pairs(atr._ef[c][k], btr._ef[c][k]), EF_BOUNDS)
               for c in sorted(atr._ef) for k in "ca"]
    ef = [p for name, ps, _ in groups if name.startswith("residual") for p in ps]
    flips = sum(int(((x == 0) != (y == 0)).sum()) for x, y in ef)
    n_ef = sum(x.size for x, _ in ef)
    worst = max(_u_stats(ps, unit)[0] for _, ps, _ in groups)
    equal = all(np.array_equal(x, y) for _, ps, _ in groups for x, y in ps)
    print(f"[chunked] {label}: chunks of 2 against the cohort plane on the card, logs "
          f"equal; parameters {_u_stats(groups[0][1], unit)} U (max, 99th percentile, "
          f"median), worst max over parameters, aux heads and residuals {worst:.3g} U, "
          f"residual entries flipped {flips} of {n_ef}, "
          + ("bit-equal" if equal else "not bit-equal"))
    for name, ps, bounds in groups:
        stats = _u_stats(ps, unit)
        if (stats[0] > tight if tight is not None
                else any(x > b for x, b in zip(stats, bounds))):
            fail(f"chunked vs cohort, {label}: {name} apart by {stats} U (max, 99th "
                 f"percentile, median), bound " + (f"max {tight}" if tight else f"{bounds}"))
    if flips > EF_FLIPS * n_ef:
        fail(f"chunked vs cohort, {label}: {flips} of {n_ef} residual entries flipped")


def phase_k1_device_time(entry: dict) -> None:
    """K1's device time (CUDA-graph replays) at the z shape, after the runs
    so the graph's memory stays out of their peak."""
    import torch

    from repro_torch.kernels import quantize
    from repro_torch.kernels.ref import int8_roundtrip_ref

    x = torch.randn((10, 2_097_152), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    scale = (x.abs().amax(dim=1) / 127.0).contiguous()
    zero = torch.zeros(x.shape[0], dtype=torch.int32, device="cuda")
    entry["device_ms"] = _graph_ms(quantize.int8_roundtrip_rows, x)
    entry["plain_device_ms"] = _graph_ms(int8_roundtrip_ref, x)
    # the yardstick of phase_kernels, in a CUDA graph
    entry["library_device_ms"] = _graph_ms_or_none(
        lambda t: torch.fake_quantize_per_channel_affine(t, scale, zero, 0, -127, 127), x)
    print(f"[kernels] int8_roundtrip at {tuple(x.shape)} fp32: device {entry['device_ms']:.4f} ms, "
          f"plain device {entry['plain_device_ms']:.4f} ms, library device "
          f"{_ms_text(entry['library_device_ms'])}")


# K4 cases: (N, S, H, KV, hd, causal, window), each in bf16 and fp32; the
# first is the path's (16 sequences of 512 tokens, 15 query heads over 5 KV
# heads, hd 64); the first ten are the rows of tests/test_torch_kernels.py
ATTN_CASES = [
    ("path", 16, 512, 15, 5, 64, True, 0),
    ("window 128", 4, 512, 15, 5, 64, True, 128),
    ("ragged S = 200", 3, 200, 6, 2, 64, True, 0),
    ("G = 1", 3, 200, 4, 4, 64, True, 0),
    ("full attention", 2, 130, 4, 2, 64, False, 0),
    ("window without causality", 2, 96, 4, 2, 64, False, 40),
    ("reduced model, hd 32", 16, 64, 4, 4, 32, True, 0),
    ("hd 128", 2, 150, 4, 1, 128, True, 0),
    ("hd 40", 2, 70, 3, 3, 40, True, 0),
    ("hd 20, element-wise staging", 2, 90, 4, 2, 20, True, 0),
    # the full-width heads of the LLM configs, 8 sequences of 512 tokens
    ("granite-3-2b heads", 8, 512, 32, 8, 64, True, 0),
    ("yi-6b heads", 8, 512, 32, 4, 128, True, 0),
    ("deepseek-67b heads", 8, 512, 64, 8, 128, True, 0),
    ("deepseek-moe-16b heads", 8, 512, 16, 16, 128, True, 0),
    ("llama4-scout heads", 8, 512, 40, 8, 128, True, 0),
]
ATTN_DTYPES = ("bfloat16", "float32")
# K3's timed rows (T, V, dtype): the path's heads (phase 11), then
# granite's odd vocab and deepseek's, the one-client launches of the MoE
# and granite runs, yi-6b's vocab at one client and at the two its run
# launches, and the ResNet's classifier (phase 28)
K3_TIMED = [
    (8_192, 49_152, "bfloat16"),
    (8_192, 49_155, "bfloat16"),
    (4_096, 102_400, "bfloat16"),
    (2_048, 102_400, "bfloat16"),
    (2_048, 49_155, "bfloat16"),
    (2_048, 64_000, "bfloat16"),
    (4_096, 64_000, "bfloat16"),
    (320, 10, "float32"),
]
# K3 cases: (T, V, dtype): the path's heads, the ResNet's classifier,
# ragged, then the LLM configs' vocabularies (granite's odd 49,155 leaves
# bf16 rows off 16-byte alignment: each row's head and tail element-wise)
XENT_CASES = [
    ("path heads", 8_192, 49_152, "bfloat16"),
    ("ResNet classifier", 320, 10, "float32"),
    ("ragged", 1_000, 50_001, "bfloat16"),
    ("granite-3-2b heads", 8_192, 49_155, "bfloat16"),
    ("granite-3-2b heads, one client", 2_048, 49_155, "bfloat16"),
    ("yi-6b heads", 2_048, 64_000, "bfloat16"),
    ("deepseek heads", 4_096, 102_400, "bfloat16"),
    ("llama4-scout heads", 2_048, 202_048, "bfloat16"),
]


def _close(got, want, rtol: float, atol: float) -> tuple[bool, float]:
    """|got - want| <= atol + rtol |want| everywhere, as torch.allclose
    (atol absolute, not scaled by the data); and the max |diff|."""
    want = want.float()
    diff = (got.float() - want).abs()
    return bool((diff <= atol + rtol * want.abs()).all()), float(diff.max())


def _ds_rounding(q, k, v, o, lse, do, grads) -> None:
    """What K4's bf16 backward keeps of dS: its dq and dk against the plain
    backward with fp32 outputs (dS in fp32), beside the plain version's own
    bf16 outputs and a plain backward whose dS is rounded to bf16, as one
    bf16 product per dQ and dK step would have it (fp32 and bf16 outputs).
    Printed only: the max |diff| of each, and max |want|."""
    import math

    import torch

    from repro_torch.kernels.ref import _grouped, _visible, attention_bwd_ref

    N, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg, dog, kf = _grouped(q, KV), _grouped(do, KV), k.float()
    D = (do.float() * o.float()).sum(-1).reshape(N, S, KV, H // KV).permute(0, 2, 3, 1)
    s = torch.einsum("nqkgd,nskd->nkgqs", qg, kf) * scale
    p = torch.where(_visible(S, True, 0, q.device),
                    torch.exp(s - lse.reshape(N, KV, H // KV, S)[..., None]), 0.0)
    ds = p * (torch.einsum("nqkgd,nskd->nkgqs", dog, v.float()) - D[..., None])
    plain = attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    products = {"dq": lambda x: torch.einsum("nkgqs,nskd->nqkgd", x, kf).reshape(N, S, H, hd),
                "dk": lambda x: torch.einsum("nkgqs,nqkgd->nskd", x, qg)}
    for i, (name, product) in enumerate(products.items()):
        want, one_bf16 = (product(x) * scale for x in (ds, ds.bfloat16().float()))
        err = {"kernel (dS as bf16 hi + lo)": grads[i], "plain, bf16 output": plain[i],
               "dS as one bf16, bf16 output": one_bf16.bfloat16(),
               "dS as one bf16, fp32 output": one_bf16}
        print(f"[kernels]   dS rounding, path bf16, {name} against the fp32-output plain "
              f"backward (max |want| {float(want.abs().max()):.4g}), max |diff|: "
              + ", ".join(f"{label} {float((x.float() - want).abs().max()):.4g}"
                          for label, x in err.items()))


def _check_k4(label: str, N: int, S: int, H: int, KV: int, hd: int, causal: bool,
              window: int, dtype, g) -> tuple[float, float]:
    """K4 forward and backward at one shape and dtype against their plain
    versions (the tolerances of tests/test_torch_kernels.py), the backward
    bit-identical run to run. Returns the max forward and backward |diff|."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

    q = torch.randn(N, S, H, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(N, S, KV, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(N, S, KV, hd, generator=g, device="cuda").to(dtype)
    do = torch.randn(N, S, H, hd, generator=g, device="cuda").to(dtype)
    o, lse = fa.attn_forward(q, k, v, causal=causal, window=window)
    grads = fa.attn_backward(q, k, v, o, lse, do, causal=causal, window=window)
    again = fa.attn_backward(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    dt = str(dtype).removeprefix("torch.")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail(f"flash_attention backward is not bit-identical run to run on {label} {dt}")
    o_want, lse_want = attention_ref(q, k, v, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    # (rtol, atol): fp32 as tests/test_kernels.py:27; bf16 measured on the
    # H100 at 3.9e-3 forward and 1.6e-2 backward, one bf16 step of a
    # gradient of magnitude 2-4 (the plain version's own output rounding
    # differs from fp32 as much), inside 1e-2 + 2e-2 |want| with room; a
    # bf16 fault of a typical output's size still fails
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
    print(f"[kernels] flash_attention {label} {(N, S, H, KV, hd)} {dt} causal={causal} "
          f"window={window}: forward max |diff| {fwd:.3g}, backward max |diff| {bwd:.3g}, "
          f"backward bit-identical run to run")
    if label == "path" and dtype == torch.bfloat16:
        _ds_rounding(q, k, v, o, lse, do, grads)
    return fwd, bwd


def _check_k3(label: str, T: int, V: int, dtype, g) -> tuple[float, float]:
    """K3 forward and backward at (T, V) against their plain versions, and
    each against itself rerun (bit-identical). Returns the max loss and
    gradient |diff|."""
    import torch

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels.ref import fused_xent_bwd_ref, fused_xent_ref

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
    loss2, lse2 = fx.xent_forward(logits, labels)
    if not (torch.equal(loss2, loss) and torch.equal(lse2, lse)
            and torch.equal(fx.xent_backward(logits, labels, lse, gt), grad)):
        fail(f"fused_xent on {label} is not bit-identical from run to run")
    print(f"[kernels] fused_xent {label} {(T, V)} {str(dtype).removeprefix('torch.')}: "
          f"loss max |diff| {fwd:.3g}, gradient max |diff| {bwd:.3g}")
    return fwd, bwd


def _merge_err(err: dict, name: str, fwd: float, bwd: float) -> None:
    err[f"{name}_forward"] = max(err[f"{name}_forward"], fwd)
    err[f"{name}_backward"] = max(err[f"{name}_backward"], bwd)


# the largest K3 |diff| at the shapes the runs launched (``_check_k3_launched``)
K3_LAUNCHED_ERR = {"fused_xent_forward": 0.0, "fused_xent_backward": 0.0}


def _check_k3_launched(label: str) -> None:
    """Every shape at which K3 launched since ``fused_xent.SHAPES`` was
    cleared, held against the plain versions as phase K3/K4 holds its
    cases; the errors join ``K3_LAUNCHED_ERR``."""
    import torch

    from repro_torch.kernels import fused_xent as fx

    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = sorted(fx.SHAPES, key=str)
    if not shapes:
        fail(f"{label}: K3 launched at no shape")
    print(f"[kernels] {label}: K3 launched at "
          + ", ".join(f"({T}, {V}) {str(dt).removeprefix('torch.')}" for T, V, dt in shapes))
    for T, V, dtype in shapes:
        _merge_err(K3_LAUNCHED_ERR, "fused_xent",
                   *_check_k3(f"{label}, as launched", T, V, dtype, g))


def phase_k3_k4() -> dict:
    """K3 and K4, forward and backward, against their plain versions on the
    same inputs (``_check_k4``, ``_check_k3``). Returns the largest |diff|
    of each of the four kernels."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(4)
    err = {"flash_attention_forward": 0.0, "flash_attention_backward": 0.0,
           "fused_xent_forward": 0.0, "fused_xent_backward": 0.0}
    for (label, *shape), dt in product(ATTN_CASES, ATTN_DTYPES):
        _merge_err(err, "flash_attention", *_check_k4(label, *shape, getattr(torch, dt), g))
    for label, T, V, dt in XENT_CASES:
        _merge_err(err, "fused_xent", *_check_k3(label, T, V, getattr(torch, dt), g))
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
    fx.SHAPES.clear()
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
    _check_k3_launched("transformer run")
    return launches


def _k4_times(N: int, S: int, H: int, KV: int, hd: int, g) -> dict:
    """K4 at (N, S, H/KV, hd), causal, bf16: CUDA events and CUDA-graph
    device time for the kernels, their plain versions and SDPA (timed here,
    never called by the port; the backward yardstick is its forward and
    autograd's backward, both captured), beside the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

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
    lib_fwd = lambda t: sdpa(t, kt, vt)                                          # noqa: E731
    lib_bwd = lambda t: torch.autograd.grad(sdpa(t, kr, vr), (t, kr, vr), dot)  # noqa: E731
    attn = {
        "forward": {"ms": _cuda_ms(fwd_fn, q), "device_ms": _graph_ms(fwd_fn, q),
                    "plain_ms": _cuda_ms(fwd_plain, q), "plain_device_ms": _graph_ms(fwd_plain, q),
                    "library_ms": _cuda_ms(lib_fwd, qt),
                    "library_device_ms": _graph_ms(lib_fwd, qt)},
        "backward": {"ms": _cuda_ms(bwd_fn, q), "device_ms": _graph_ms(bwd_fn, q),
                     "plain_ms": _cuda_ms(bwd_plain, q),
                     "plain_device_ms": _graph_ms(bwd_plain, q),
                     "library_ms": _cuda_ms(lib_bwd, qr),
                     "library_device_ms": _graph_ms(lib_bwd, qr)},
    }
    pairs = N * H * S * (S + 1) // 2                 # causal (query, key) pairs
    q_bytes, kv_bytes, lse_bytes = 2 * N * S * H * hd, 2 * N * S * KV * hd, 4 * N * H * S
    attn["forward"]["bound_ms"], attn["forward"]["bound_by"] = _bound(
        2 * q_bytes + 2 * kv_bytes + lse_bytes, 2 * 2 * pairs * hd, BF16_OPS_PER_S)
    attn["backward"]["bound_ms"], attn["backward"]["bound_by"] = _bound(
        4 * q_bytes + 4 * kv_bytes + lse_bytes, 5 * 2 * pairs * hd, BF16_OPS_PER_S)
    return attn


def _k3_times(T: int, V: int, dtype, g) -> dict:
    """K3 at (T, V) in ``dtype``, as ``_k4_times``; the yardstick is
    ``F.cross_entropy`` (``reduction="none"``). The bound counts the
    logits' bytes at their element size, the int64 labels, and the fp32
    loss and lse (forward) or lse and cotangent (backward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels.ref import fused_xent_bwd_ref, fused_xent_ref

    logits = (3 * torch.randn(T, V, generator=g, device="cuda")).to(dtype)
    labels = torch.randint(0, V, (T,), generator=g, device="cuda")
    gt = torch.randn(T, generator=g, device="cuda")
    _, xlse = fx.xent_forward(logits, labels)
    lr = logits.clone().requires_grad_(True)
    xfwd = partial(fx.xent_forward, labels=labels)
    xbwd = partial(fx.xent_backward, labels=labels, lse=xlse, g=gt)
    xfwd_plain = partial(fused_xent_ref, labels=labels)
    xbwd_plain = partial(fused_xent_bwd_ref, labels=labels, lse=xlse, g=gt)
    xlib_fwd = partial(F.cross_entropy, target=labels, reduction="none")
    xlib_bwd = lambda t: torch.autograd.grad(xlib_fwd(t), t, gt)                # noqa: E731
    xent = {
        "forward": {"ms": _cuda_ms(xfwd, logits), "device_ms": _graph_ms(xfwd, logits),
                    "plain_ms": _cuda_ms(xfwd_plain, logits),
                    "plain_device_ms": _graph_ms(xfwd_plain, logits),
                    "library_ms": _cuda_ms(xlib_fwd, logits),
                    "library_device_ms": _graph_ms(xlib_fwd, logits)},
        "backward": {"ms": _cuda_ms(xbwd, logits), "device_ms": _graph_ms(xbwd, logits),
                     "plain_ms": _cuda_ms(xbwd_plain, logits),
                     "plain_device_ms": _graph_ms(xbwd_plain, logits),
                     "library_ms": _cuda_ms(xlib_bwd, lr),
                     "library_device_ms": _graph_ms(xlib_bwd, lr)},
    }
    size = logits.element_size()
    xent["forward"]["bound_ms"], xent["forward"]["bound_by"] = _bound(
        size * T * V + 8 * T + 8 * T, 3 * T * V)
    xent["backward"]["bound_ms"], xent["backward"]["bound_by"] = _bound(
        2 * size * T * V + 8 * T + 8 * T, 4 * T * V)
    return xent


def _print_times(name: str, shape: str, times: dict) -> None:
    for direction in ("forward", "backward"):
        t = times[direction]
        print(f"[kernels] {name} {direction} at {shape}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms (device "
              f"{t['plain_device_ms']:.4f} ms), library {t['library_ms']:.4f} ms (device "
              f"{t['library_device_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), {100 * t['bound_ms'] / t['device_ms']:.1f}% of it on "
              f"device time")


def phase_k3_k4_times(err: dict) -> list[dict]:
    """K3 and K4 times at the SmolLM-360M path's shapes (``_k4_times``,
    ``_k3_times``): 16 sequences x 15 heads over 5, S = 512, hd 64; 8,192
    tokens over a vocab of 49,152."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    entries = []
    attn = _k4_times(16, 512, 15, 5, 64, g)
    T, V, dtype = K3_TIMED[0]
    xent = _k3_times(T, V, getattr(torch, dtype), g)
    for name, times, src, replaces, shape in (
            ("flash_attention", attn, "flash_attention.cu", "flash_attention.py:75",
             "(16, 512, 15/5, 64) bf16 causal"),
            ("fused_xent", xent, "fused_xent.cu", "fused_xent.py:62", "(8192, 49152) bf16")):
        _print_times(name, shape, times)
        for direction in ("forward", "backward"):
            entries.append({
                "name": f"{name}_{direction}",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": None,        # filled from the transformer run
                "max_abs_err": err[f"{name}_{direction}"],
                **times[direction],
            })
    return entries


# K5 cases: (label, BH, S, dh); the first is the xLSTM path's (3 clients x 4
# sequences x 4 heads, 512 tokens, mLSTM head dim 512: two chunks of 256)
MLSTM_CASES = [
    ("path", 48, 512, 512),
    ("reduced model, dh 64", 24, 320, 64),
    ("ragged S = 96, dh 32", 3, 96, 32),
    ("ragged S = 200, dh 128", 3, 200, 128),
    ("ragged S = 300, dh 256", 2, 300, 256),
    ("ragged S = 130, odd dh 37", 2, 130, 37),    # 4-byte copies
]
# absolute tolerances of tests/test_torch_kernels.py (6x or more the largest
# errors measured at the path's shape: h 3.3e-5, dq 1.5e-4, dv 2.7e-5, dk
# 2.3e-3, d log_f 1.4e-3, d i 1.5e-3 on an H100 80GB HBM3 at 700 W)
MLSTM_TOL = {"h": 2e-4, "dq": 2e-3, "dk": 2e-2, "dv": 2e-4, "dlf": 2e-2, "dig": 2e-2}
MLSTM_OUTPUTS = ("h", "dq", "dk", "dv", "dlf", "dig")


def _mlstm_inputs(BH, S, dh, g):
    """q ~ N(0, 1), k ~ N(0, 1/dh) (the model divides k by sqrt(dh)), v ~
    N(0, 1), forget gates log_sigmoid(N(3, 1)) (the model's bias 3), input
    gates sigmoid(N(0, 1)); fp32 on the card."""
    import torch
    import torch.nn.functional as F

    q = torch.randn(BH, S, dh, generator=g, device="cuda")
    k = torch.randn(BH, S, dh, generator=g, device="cuda") / dh ** 0.5
    v = torch.randn(BH, S, dh, generator=g, device="cuda")
    lf = F.logsigmoid(torch.randn(BH, S, generator=g, device="cuda") + 3)
    ig = torch.sigmoid(torch.randn(BH, S, generator=g, device="cuda"))
    return q, k, v, lf, ig


def phase_k5() -> dict:
    """K5 forward and backward against the plain chunk form and autograd
    through it, on the same inputs; the backward twice, bit-identical.
    Returns the largest |diff| of the forward and of the backward."""
    import torch

    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels.ref import mlstm_chunk_ref

    g = torch.Generator(device="cuda").manual_seed(6)
    err = {"mlstm_chunk_forward": 0.0, "mlstm_chunk_backward": 0.0}
    for label, BH, S, dh in MLSTM_CASES:
        ins = _mlstm_inputs(BH, S, dh, g)
        gout = torch.randn(BH, S, dh, generator=g, device="cuda")
        h, saved = mk.mlstm_forward(*ins)
        grads = mk.mlstm_backward(*ins, h, saved, gout)
        again = mk.mlstm_backward(*ins, h, saved, gout)
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_(True) for t in ins]
        want_h = mlstm_chunk_ref(*leaves)
        want = torch.autograd.grad(want_h, leaves, gout)
        fwd = float((h - want_h.detach()).abs().max())
        if not fwd <= MLSTM_TOL["h"]:
            fail(f"mlstm_chunk forward differs from its plain version on {label}: max |diff| {fwd}")
        bwd = {}
        for name, a, b in zip(("dq", "dk", "dv", "dlf", "dig"), grads, want):
            bwd[name] = float((a - b).abs().max())
            if not bool(torch.isfinite(a).all()) or not bwd[name] <= MLSTM_TOL[name]:
                fail(f"mlstm_chunk backward {name} differs from its plain version on {label}: "
                     f"max |diff| {bwd[name]}")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"mlstm_chunk backward is not bit-identical run to run on {label}")
        err["mlstm_chunk_forward"] = max(err["mlstm_chunk_forward"], fwd)
        err["mlstm_chunk_backward"] = max(err["mlstm_chunk_backward"], max(bwd.values()))
        print(f"[kernels] mlstm_chunk {label} {(BH, S, dh)} fp32: forward max |diff| {fwd:.3g}, "
              f"backward max |diff| " + ", ".join(f"{k} {v:.3g}" for k, v in bwd.items())
              + ", backward bit-identical run to run")
        if label in MLSTM_F64_CASES:
            _k5_against_float64(label, ins, gout, (h, *grads), (want_h.detach(), *want))
    return err


# the K5 cases also held against the plain chunk form in float64
MLSTM_F64_CASES = ("path", "ragged S = 300, dh 256")


def _k5_against_float64(label, ins, gout, got, plain) -> None:
    """Each K5 output (h and the five gradients) against the plain chunk form
    run in float64 on the card: the kernel's max |error| may be at most 4x
    the fp32 plain form's own."""
    import torch

    from repro_torch.kernels.ref import mlstm_chunk_ref

    leaves = [t.double().requires_grad_(True) for t in ins]
    want_h = mlstm_chunk_ref(*leaves)
    want = (want_h.detach(), *torch.autograd.grad(want_h, leaves, gout.double()))
    parts = []
    for name, a, b, w in zip(MLSTM_OUTPUTS, got, plain, want):
        kernel_err = float((a.double() - w).abs().max())
        plain_err = float((b.double() - w).abs().max())
        parts.append(f"{name} {kernel_err:.3g} (plain fp32 {plain_err:.3g}, "
                     f"{kernel_err / plain_err:.2f}x)")
        if not kernel_err <= 4 * plain_err:
            fail(f"mlstm_chunk {name} on {label}: error against float64 {kernel_err} is above 4x "
                 f"the fp32 plain form's {plain_err}")
    print(f"[kernels] mlstm_chunk {label} against float64: max |error| " + ", ".join(parts))


XLSTM_ARGV = ["--arch", "xlstm-350m", "--full-size", "--clients", "3", "--batch-size", "4",
              "--seq-len", "512", "--scheduler", "dynamic", "--lr", "1e-3", "--device", "cuda"]
# 320 tokens: two K5 chunks on the card (256 + 64), two of 160 in the CPU's plain form
XLSTM_SMALL = ["--arch", "xlstm-350m", "--clients", "4", "--batch-size", "4",
               "--seq-len", "320", "--rounds", "3"]


def _k3_k5_counts() -> dict:
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import mlstm_chunk as mk

    return {"fused_xent_forward": fx.LAUNCHES["forward"],
            "fused_xent_backward": fx.LAUNCHES["backward"],
            "mlstm_chunk_forward": mk.LAUNCHES["forward"],
            "mlstm_chunk_backward": mk.LAUNCHES["backward"]}


def phase_xlstm_run() -> dict:
    """DTFL on full-width xLSTM-350M; every round must launch K5 and K3,
    forward and backward."""
    import gc

    import torch

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.launch import train

    rounds = []
    shapes = {}

    def on_round(trainer, log):
        if not shapes:
            shapes.update(_check_trees_finite(trainer))
        else:
            _check_trees_finite(trainer, shapes)
        rounds.append((log, _k3_k5_counts()))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fx.LAUNCHES.update(forward=0, backward=0)
    mk.LAUNCHES.update(forward=0, backward=0)
    fx.SHAPES.clear()
    logs = train.main(XLSTM_ARGV + ["--rounds", "3"], on_round=on_round)
    launches = _k3_k5_counts()
    peak = torch.cuda.max_memory_allocated()

    if len(logs) != 3 or len(rounds) != 3:
        fail(f"xLSTM run: expected 3 rounds, got {len(logs)}")
    before = dict.fromkeys(launches, 0)
    for log, count in rounds:
        got = {k: count[k] - before[k] for k in count}
        if min(got.values()) <= 0:
            fail(f"xLSTM run round {log.round} launched no kernel of {got}")
        tiers = sorted(set(log.assignment.values()))
        print(f"[xlstm] round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, uplink_bytes {log.uplink_bytes:.0f}, tiers {tiers}, "
              f"acc {log.acc:.4f}, launches K5 forward {got['mlstm_chunk_forward']} backward "
              f"{got['mlstm_chunk_backward']}, K3 forward {got['fused_xent_forward']} backward "
              f"{got['fused_xent_backward']}")
        before = count
    print(f"[xlstm] peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    _check_k3_launched("xLSTM run")
    return launches


def _mlstm_work(BH: int, S: int, dh: int) -> tuple[float, float, float, float]:
    """The fp32 operations and bytes K5's forward and backward need on these
    shapes, in chunks of 256: products only where s <= t, no product with the
    zero state of the first chunk, no state update after the last. Returns
    (forward ops, forward bytes, backward ops, backward bytes)."""
    from repro_torch.kernels.mlstm_chunk import CHUNK

    lens = [min(CHUNK, S - c0) for c0 in range(0, S, CHUNK)]
    tri = sum(L * (L + 1) // 2 for L in lens) * dh          # one causal (P, P, dh) product
    mid = sum(L for L in lens[1:]) * dh * dh                # q C, or its transpose
    end = sum(L for L in lens[:-1]) * dh * dh               # the state update
    fwd_macs = 2 * tri + mid + end + 2 * S * dh             # scores, A v; n.q, n update
    # backward: dA = g v^T, dS k, dS^T q, A^T g; C g (dq), dC v and k dC (dk,
    # dv), the dC walk. The gate terms come from dA * A with A kept from the
    # forward; the kernel's recompute of the scores is its own choice, not
    # counted.
    bwd_macs = 4 * tri + 2 * mid + 2 * end + 3 * S * dh
    row = BH * S * dh * 4
    return (2.0 * BH * fwd_macs, 4.0 * row + 8 * BH * S,
            2.0 * BH * bwd_macs, 8.0 * row + 16 * BH * S)


def k5_kernel_profile(BH: int, S: int, dh: int) -> None:
    """torch.profiler over ten K5 forwards and backwards at (BH, S, dh) fp32:
    the per-call device ms of every traced kernel whose name holds "mlstm",
    printed. A trace with no device time prints "not measured"."""
    import re

    import torch

    from repro_torch.kernels import mlstm_chunk as mk

    g = torch.Generator(device="cuda").manual_seed(8)
    ins = _mlstm_inputs(BH, S, dh, g)
    gout = torch.randn(BH, S, dh, generator=g, device="cuda")
    h, saved = mk.mlstm_forward(*ins)
    mk.mlstm_backward(*ins, h, saved, gout)
    torch.cuda.synchronize()

    calls = 10

    def run():
        for _ in range(calls):
            hh, ss = mk.mlstm_forward(*ins)
            mk.mlstm_backward(*ins, hh, ss, gout)
        torch.cuda.synchronize()

    _, totals = _profile(run)
    per_call = {}
    for key, (n, t) in sorted(totals.items()):
        if m := re.search(r"mlstm_\w+", key):
            per_call[m.group(0)] = per_call.get(m.group(0), 0.0) + t * 1e3 / calls
    if not per_call:
        print(f"[profile] K5 kernels at {(BH, S, dh)}: no device time in the trace (not measured)")
    for name, ms in per_call.items():
        print(f"[profile] K5 {name} at {(BH, S, dh)}: {ms:.4f} ms device time per call")


def phase_k5_times(err: dict) -> list[dict]:
    """K5 at the xLSTM path's shape (48, 512, 512) fp32: CUDA events and
    CUDA-graph device time for the kernels and the plain forward; events for
    the plain backward (autograd through the plain chunk form, its graph
    kept). No PyTorch call computes an mLSTM: no library yardstick."""
    import torch

    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels.ref import mlstm_chunk_ref

    g = torch.Generator(device="cuda").manual_seed(7)
    BH, S, dh = 48, 512, 512
    ins = _mlstm_inputs(BH, S, dh, g)
    gout = torch.randn(BH, S, dh, generator=g, device="cuda")
    h, saved = mk.mlstm_forward(*ins)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    want_h = mlstm_chunk_ref(*leaves)
    q = ins[0]
    fwd_fn = lambda t: mk.mlstm_forward(t, *ins[1:])               # noqa: E731
    bwd_fn = lambda t: mk.mlstm_backward(t, *ins[1:], h, saved, gout)  # noqa: E731
    fwd_plain = lambda t: mlstm_chunk_ref(t, *ins[1:])              # noqa: E731
    bwd_plain = lambda t: torch.autograd.grad(want_h, leaves, gout, retain_graph=True)  # noqa: E731
    times = {
        "forward": {"ms": _cuda_ms(fwd_fn, q), "device_ms": _graph_ms(fwd_fn, q),
                    "plain_ms": _cuda_ms(fwd_plain, q), "plain_device_ms": _graph_ms(fwd_plain, q),
                    "library_ms": None},
        "backward": {"ms": _cuda_ms(bwd_fn, q), "device_ms": _graph_ms(bwd_fn, q),
                     "plain_ms": _cuda_ms(bwd_plain, q), "library_ms": None},
    }
    fops, fbytes, bops, bbytes = _mlstm_work(BH, S, dh)
    times["forward"]["bound_ms"], times["forward"]["bound_by"] = _bound(fbytes, fops)
    times["backward"]["bound_ms"], times["backward"]["bound_by"] = _bound(bbytes, bops)
    entries = []
    for direction in ("forward", "backward"):
        t = times[direction]
        ops = fops if direction == "forward" else bops
        # the same work as three TF32 products per fp32 one on the tensor cores
        split_ms = _bound(fbytes if direction == "forward" else bbytes, 3 * ops,
                          TF32_OPS_PER_S)[0]
        print(f"[kernels] mlstm_chunk {direction} at {(BH, S, dh)} fp32: kernel {t['ms']:.4f} ms "
              f"(device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms"
              + (f" (device {t['plain_device_ms']:.4f} ms)" if "plain_device_ms" in t else "")
              + f", bound {t['bound_ms']:.4f} ms ({t['bound_by']}; {ops / 1e9:.2f} GFLOP at the "
              f"fp32 rate), split-TF32 bound {split_ms:.4f} ms ({3 * ops / 1e9:.2f} GFLOP at the "
              f"TF32 rate)")
        entries.append({
            "name": f"mlstm_chunk_{direction}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
            "replaces": "src/repro/kernels/mlstm_chunk.py:71",
            "launches": None,        # filled from the xLSTM run
            "max_abs_err": err[f"mlstm_chunk_{direction}"],
            **t,
        })
    k5_kernel_profile(BH, S, dh)
    return entries


# The LLM configs at full width (d_model, heads, d_ff, experts, vocab as
# published), their depth cut so one card holds the run: (arch, layers,
# modules, clients, batch, rounds, dcor_alpha); 512 tokens a sequence, 2
# batches a client, priced on the full config as the CLI prices it.
LLM_SEQ = 512
LLM_RUNS = {
    "granite-3-2b + dcor": ("granite-3-2b", 4, 4, 4, 4, 3, 0.5),
    "yi-6b": ("yi-6b", 2, 2, 2, 4, 2, 0.0),
    "deepseek-moe-16b": ("deepseek-moe-16b", 2, 2, 1, 4, 3, 0.0),
}
# the reduced configs on the card and the CPU: the CLI at --arch (SMOLLM_SMALL's sizes)
LLM_ARCHS = ("granite-3-2b", "yi-6b", "deepseek-67b", "deepseek-moe-16b",
             "llama4-scout-17b-a16e")


def _llm_trainer(arch, n_layers, n_modules, clients, batch, dcor_alpha):
    """DTFL on ``arch`` at full width cut to ``n_layers`` layers in
    ``n_modules`` modules, built as the CLI builds a transformer run (the CLI
    has no depth flag): the LM task, ``batch`` x 512 tokens, 2 batches a
    client, the paper's profiles, Adam 1e-3, seed 0; the time model prices
    the full config."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SeqClientDataset
    from repro_torch.data.synthetic import SeqTask
    from repro_torch.fed.adapter import TransformerAdapter
    from repro_torch.fed.client import HeteroEnv, SimClient
    from repro_torch.fed.dtfl import DTFLTrainer

    full = get_config(arch)
    ad = TransformerAdapter(full.replace(n_layers=n_layers, n_modules=n_modules),
                            seq_len=LLM_SEQ, cost_cfg=full, dcor_alpha=dcor_alpha)
    task = SeqTask(vocab=ad.cfg.vocab)
    data = [SimClient(i, SeqClientDataset(task, 2, batch, LLM_SEQ, i), None)
            for i in range(clients)]
    trainer = DTFLTrainer(ad, data, HeteroEnv(clients), optim.adam(1e-3), seed=0,
                          device="cuda")
    return trainer, next(task.batches(batch, LLM_SEQ, 1, seed=99))


def _llm_reckoning(arch, n_layers, n_modules, clients, batch) -> dict:
    """Device memory of an LLM run reckoned from the shapes of ``init`` on
    the meta device, in GiB: the cohort's state, 28 B a client-parameter
    (weights, gradients, Adam's m and v, and the new weights, m and v that
    the optimizer builds beside the old before the step returns: 7 x 4 B;
    the SmolLM-360M and xLSTM-350M runs' peaks came to 29-31 B); the global
    model and the per-tier aux heads (4 B); the aux head's and the server's
    logits, bf16, with their gradients; Adam's temporaries on the largest
    leaf (5 x 4 B). Activations are not counted."""
    from repro_torch.configs import get_config
    from repro_torch.core import tiering
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).replace(n_layers=n_layers, n_modules=n_modules,
                                   tie_embeddings=False)
    model = tree_leaves(M.init(None, cfg, device="meta"))
    aux = tree_leaves(M.aux_head_init(None, cfg, device="meta"))
    p_model, p_aux = sum(t.numel() for t in model), sum(t.numel() for t in aux)
    largest = max(t.numel() for t in model + aux)
    gib = 2.0 ** 30
    parts = {
        "cohort state": 28 * clients * (p_model + p_aux) / gib,
        "global model + aux heads": 4 * (p_model + tiering.n_tiers(cfg) * p_aux) / gib,
        "logits": 4 * 2 * clients * batch * LLM_SEQ * cfg.padded_vocab / gib,
        "Adam temporaries": 5 * 4 * clients * largest / gib,
    }
    return {"params a client": p_model + p_aux, "parts": parts, "total": sum(parts.values())}


def _kernel_counts() -> dict:
    from repro_torch.kernels import dcor

    return {**_k3_k4_counts(), "pairwise_dist_forward": dcor.LAUNCHES["forward"],
            "pairwise_dist_backward": dcor.LAUNCHES["backward"]}


def _moe_routes(params, cfg, batch: dict, device: str) -> tuple[list, "torch.Tensor"]:
    """One model's forward (no client axis in ``params`` or ``batch``) on
    ``device``, with the router read through a wrapper around
    ``models/moe.py::route``: each MoE layer's (probabilities, top-k
    probabilities, top-k experts, queue positions), in layer order, and the
    model's load-balance loss (the sum over layers, ``moe_aux``)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    from repro_torch.models import transformer as tfm

    real, seen = moe.route, []
    moe.route = lambda x, p, c: seen.append(real(x, p, c)) or seen[-1]
    try:
        with torch.no_grad():
            _, aux = M.forward(tree_map(lambda t: t[None].to(device), params), cfg,
                               {k: v[None].to(device) for k, v in batch.items()})
    finally:
        moe.route = real
    n_moe = cfg.n_layers if tfm.block_kind(cfg) == "moe" else 0
    if len(seen) != n_moe:
        fail(f"read {len(seen)} routes from {n_moe} MoE layers: moe_apply no longer routes "
             f"through models/moe.py::route")
    return seen, aux[0]


def _moe_layer_stats(trainer, batch: dict) -> tuple[list[float], float]:
    """The global model on one client's batch: each MoE layer's share of
    dropped (token, k) assignments, and ``moe_aux``."""
    from repro_torch.models import moe

    cfg = trainer.adapter.cfg
    routes, aux = _moe_routes(trainer.params, cfg, batch, "cuda")
    return [float((pos >= moe.capacity(pos.shape[2], cfg)).float().mean())
            for *_, pos in routes], float(aux)


def _check_launched(label: str) -> dict:
    """Every shape at which K2, K3 and K4 launched since their ``SHAPES``
    were cleared, held against the plain versions as phases K2 and K3/K4
    hold their cases. Returns the max |diff| of each kernel, forward and
    backward."""
    import torch

    from repro_torch.kernels import dcor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx

    g = torch.Generator(device="cuda").manual_seed(10)
    err = {f"{k}_{d}": 0.0 for k in ("pairwise_dist", "flash_attention", "fused_xent")
           for d in ("forward", "backward")}
    what = f"{label}, as launched"
    for shape in sorted(dcor.SHAPES):
        _merge_err(err, "pairwise_dist", *_check_k2(what, shape, g))
    for shape in sorted(fa.SHAPES, key=str):
        _merge_err(err, "flash_attention", *_check_k4(what, *shape, g))
    for T, V, dtype in sorted(fx.SHAPES, key=str):
        _merge_err(err, "fused_xent", *_check_k3(what, T, V, dtype, g))
    return err


def phase_llm_run(label: str) -> dict:
    """One LLM run at full width (``LLM_RUNS``): its memory reckoned before
    it starts and measured after; per round wall, clock, tiers, uplink
    bytes and kernel launches (every round must launch K3 and K4 forward
    and backward, and K2 both ways with dcor); for MoE also each layer's
    share of dropped assignments and ``moe_aux``; every parameter and aux
    head finite and of its shape. Then, with the trainer freed, each K2,
    K3 and K4 shape that the run launched is held against its plain
    version (``_check_launched``); returns the max |diff| of each."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import dcor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx

    arch, n_layers, n_modules, clients, batch, n_rounds, alpha = LLM_RUNS[label]
    want = _llm_reckoning(arch, n_layers, n_modules, clients, batch)
    print(f"[llm] {label}: {n_layers} layers in {n_modules} modules, {clients} clients, batch "
          f"{batch} x {LLM_SEQ}, {n_rounds} rounds, dcor_alpha {alpha}; "
          f"{want['params a client'] / 1e6:.1f}M parameters a client (aux head included); "
          f"memory reckoned {want['total']:.2f} GiB ("
          + ", ".join(f"{k} {v:.2f}" for k, v in want["parts"].items()) + ")")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, eval_batch = _llm_trainer(arch, n_layers, n_modules, clients, batch, alpha)
    build_s = time.perf_counter() - t0
    moe_family = trainer.adapter.cfg.family == "moe"
    first = {k: torch.from_numpy(v) for k, v in next(trainer.clients[0].dataset.epoch(0)).items()}
    rows, shapes = [], {}

    def on_round(tr, log):
        if not shapes:
            shapes.update(_check_trees_finite(tr))
        else:
            _check_trees_finite(tr, shapes)
        counts = _kernel_counts()
        stats = _moe_layer_stats(tr, first) if moe_family else None
        rows.append((log, counts, _kernel_counts(), stats))

    fx.LAUNCHES.update(forward=0, backward=0)
    fa.LAUNCHES.update(forward=0, backward=0)
    dcor.LAUNCHES.update(forward=0, backward=0)
    for shapes_launched in (fx.SHAPES, fa.SHAPES, dcor.SHAPES):
        shapes_launched.clear()
    logs = trainer.run(n_rounds, eval_batch, on_round=on_round)
    peak = torch.cuda.max_memory_allocated() / 2**30, torch.cuda.max_memory_reserved() / 2**30
    if len(logs) != n_rounds or len(rows) != n_rounds:
        fail(f"{label} run: expected {n_rounds} rounds, got {len(logs)}")
    need = ["fused_xent_forward", "fused_xent_backward", "flash_attention_forward",
            "flash_attention_backward"]
    if alpha > 0:
        need += ["pairwise_dist_forward", "pairwise_dist_backward"]
    base = dict.fromkeys(rows[0][1], 0)
    for log, counts, after, stats in rows:
        got = {k: counts[k] - base[k] for k in counts}
        if min(got[k] for k in need) <= 0:
            fail(f"{label} run round {log.round} launched no kernel of {got}")
        print(f"[llm] {label} round {log.round}: wall {log.wall_s:.3f} s, sim clock "
              f"{log.clock:.4f} s, uplink_bytes {log.uplink_bytes:.0f}, tiers "
              f"{sorted(set(log.assignment.values()))}, acc {log.acc:.4f}, launches K3 "
              f"{got['fused_xent_forward']} / {got['fused_xent_backward']}, K4 "
              f"{got['flash_attention_forward']} / {got['flash_attention_backward']}, K2 "
              f"{got['pairwise_dist_forward']} / {got['pairwise_dist_backward']} "
              "(forward / backward)"
              + ("" if stats is None else
                 ", dropped assignments by layer "
                 + ", ".join(f"{x:.2%}" for x in stats[0]) + f", moe_aux {stats[1]:.4f}"))
        if stats is not None and not np.isfinite(stats[1]):
            fail(f"{label} run: moe_aux is not finite")
        base = after
    print(f"[llm] {label}: memory reckoned {want['total']:.2f} GiB, measured peak allocated "
          f"{peak[0]:.3f} GiB (reserved {peak[1]:.3f} GiB); trainer built in {build_s:.1f} s")
    print(f"[llm] {label}: launched K2 at {sorted(dcor.SHAPES)}, K3 at "
          f"{sorted((T, V) for T, V, _ in fx.SHAPES)}, K4 (N, S, H, KV, hd) at "
          f"{sorted(sh[:5] for sh in fa.SHAPES)}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return _check_launched(label)


# the reduced MoE configs in bf16 spread further than the dense ones: a
# route flipped at a near-tie moves a token's whole expert update. The card
# read max 0.469 / 0.426 U, 99th percentile 0.137 / 0.155 U, median 0.0054 /
# 0.0066 U on deepseek-moe-16b / llama4-scout (H100 80GB HBM3, 700 W); the
# JAX package against itself from weights moved by one ulp reads 0.44 /
# 0.14 / 0.0054 U on deepseek-moe-16b (tests/test_torch_llm_configs.py,
# test_three_rounds_bf16_moe_within_the_jax_package_own_spread). Held as
# the xLSTM's: max 1 U, 99th percentile 0.3 U, median 0.01 U.
MOE_REFERENCE_BOUNDS = (1.0, 0.3, 0.01)


def phase_llm_reference(arch: str, extra: list[str]) -> None:
    """The reduced ``arch`` through the CLI on the card and on the CPU
    (``phase_small_reference``; an MoE config within MOE_REFERENCE_BOUNDS);
    for an MoE config also the count of routes (each token's top-k experts,
    every layer) that differ when the CPU run's final model routes client
    0's first batch on the card and on the CPU."""
    import torch

    from repro_torch.configs import get_config

    argv = ["--arch", arch, "--clients", "4", "--batch-size", "4", "--seq-len", "64",
            "--rounds", "3"] + extra
    moe_family = get_config(arch).family == "moe"
    gtr, ctr = phase_small_reference(argv, " ".join([arch] + extra),
                                     MOE_REFERENCE_BOUNDS if moe_family else (0.5, 0.1, 0.01))
    if not moe_family:
        return
    batch = {k: torch.from_numpy(v) for k, v in next(ctr.clients[0].dataset.epoch(0)).items()}
    routes = {device: [topi.cpu() for _, _, topi, _ in
                       _moe_routes(ctr.params, ctr.adapter.cfg, batch, device)[0]]
              for device in ("cuda", "cpu")}
    differ = sum(int((a != b).sum()) for a, b in zip(routes["cuda"], routes["cpu"]))
    total = sum(a.numel() for a in routes["cpu"])
    print(f"[reference]   {arch}: routes of the CPU run's final model on client 0's first "
          f"batch, card against CPU: {differ} of {total} (token, k) choices differ")


def _profile_with_ops(fn):
    """``fn()`` under torch.profiler with host and device activity and input
    shapes: (fn's result, kernel totals, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        out = fn()
    return out, _kernel_totals(prof), prof


def phase_llm_times_and_moe_profile() -> None:
    """K4 at deepseek-moe-16b's heads (8, 512, 16/16, 128) and K3 at the
    rows of ``K3_TIMED`` after the path's, timed as phase 11 does; then
    torch.profiler over two rounds of the MoE run: the device busy share,
    K3's and K4's shares, the share of the dispatch and combine einsums
    (every ``aten::bmm``, forward or backward, over the group's E x
    capacity expert slots), the top kernels and the top operators (self
    device time, input shapes). Printed only."""
    import gc

    import torch

    from repro_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(9)
    _print_times("flash_attention", "(8, 512, 16/16, 128) bf16 causal",
                 _k4_times(8, 512, 16, 16, 128, g))
    for T, V, dtype in K3_TIMED[1:]:
        _print_times("fused_xent", f"({T}, {V}) {dtype}",
                     _k3_times(T, V, getattr(torch, dtype), g))

    gc.collect()
    torch.cuda.empty_cache()
    arch, n_layers, n_modules, clients, batch, _, alpha = LLM_RUNS["deepseek-moe-16b"]
    trainer, eval_batch = _llm_trainer(arch, n_layers, n_modules, clients, batch, alpha)
    cfg = trainer.adapter.cfg
    G, Tg = moe.group_shape(batch * LLM_SEQ)
    slots = cfg.n_experts * moe.capacity(Tg, cfg)
    logs, totals, prof = _profile_with_ops(lambda: trainer.run(2, eval_batch))
    busy = sum(t for _, t in totals.values())
    if not busy:
        print("[profile] MoE run: no device time in the trace (not measured)")
        return
    wall = sum(log.wall_s for log in logs)
    einsum_s, einsum_n = 0.0, 0
    for ev in prof.key_averages(group_by_input_shape=True):
        dims = [d for shape in ev.input_shapes for d in shape]
        if ev.key == "aten::bmm" and slots in dims and clients * G in dims:
            einsum_s += ev.device_time_total / 1e6
            einsum_n += ev.count
    k3, k4 = _named(totals, K3_KERNELS)[1], _named(totals, K4_KERNELS)[1]
    print(f"[profile] MoE run (deepseek-moe-16b), rounds 0-1 under the profiler: wall "
          f"{wall:.3f} s, device busy {busy:.3f} s ({busy / wall:.1%} of wall), K3 {k3:.4f} s "
          f"({k3 / busy:.2%} of device time), K4 {k4:.4f} s ({k4 / busy:.2%}), dispatch and "
          f"combine einsums {einsum_s:.4f} s ({einsum_s / busy:.2%}; {einsum_n} bmm calls over "
          f"{slots} expert slots a group), {sum(n for n, _ in totals.values())} device "
          "activities")
    for key, (n, t) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[profile]   {t:.4f} s  {n:6d} x  {key[:90]}")
    # the same device time by the operator that launched it, with its shapes
    ops = sorted((ev for ev in prof.key_averages(group_by_input_shape=True)
                  if ev.self_device_time_total > 0), key=lambda ev: -ev.self_device_time_total)
    for ev in ops[:10]:
        print(f"[profile]   {ev.self_device_time_total / 1e6:.4f} s  {ev.count:6d} x  op "
              f"{ev.key} {str(ev.input_shapes)[:100]}")


def k3_alone(src: Path) -> None:
    """``python3 chip_smoke.py --k3 [SRC]``: K3 alone, from the port under
    SRC (this checkout's ``src`` by default): build it, its build report,
    its cases against the plain versions, then the rows of ``K3_TIMED``.
    Run on two checkouts in turns within one call, it compares them on one
    card."""
    sys.path.insert(0, str(src.resolve()))
    smi = phase_device()
    import torch

    from repro_torch.kernels import fused_xent, nvcc

    t0 = time.perf_counter()
    fused_xent.load_library()
    print(f"[build] fused_xent from {src}: {time.perf_counter() - t0:.2f} s")
    print(nvcc.library_path("fused_xent").with_suffix(".log").read_text().strip())
    k3_build_report()
    g = torch.Generator(device="cuda").manual_seed(4)
    for label, T, V, dt in XENT_CASES:
        _check_k3(label, T, V, getattr(torch, dt), g)
    g = torch.Generator(device="cuda").manual_seed(9)
    for T, V, dtype in K3_TIMED:
        _print_times("fused_xent", f"({T}, {V}) {dtype}",
                     _k3_times(T, V, getattr(torch, dtype), g))
    print(smi)


def main() -> None:
    if sys.argv[1:2] == ["--k3"]:
        k3_alone(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT / "src")
        return
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    # each phase's GiB: its peak of reserved memory on an H100 80GB HBM3, rounded
    # up; for the two big runs their peak allocated (53.7, 66.3 GiB) plus room
    entry = _phase("K1", 1, phase_kernels)
    k2_err = _phase("K2", 1, phase_k2)
    k34_err = _phase("K3/K4", 16, phase_k3_k4)
    k5_err = _phase("K5", 4, phase_k5)
    k1_launches, dtfl_clock = _phase("main path", 7, phase_main_path)
    k2_launches = _phase("dcor run", 5, phase_dcor_run)
    k34_launches = _phase("transformer run", 60, phase_transformer_run)
    k35_launches = _phase("xLSTM run", 72, phase_xlstm_run)
    _phase("int8 reference", 1, phase_small_reference, RESNET_SMALL + ["--codec", "int8"],
           "int8")
    _phase("dcor reference", 1, phase_small_reference,
           RESNET_SMALL + ["--dcor-alpha", "0.5"], "dcor")
    _phase("token-LM reference", 1, phase_small_reference, SMOLLM_SMALL, "token-LM")
    # the card read max 0.478 U, 99th percentile 0.166 U, median 0.0040 U at
    # 320 tokens (H100 80GB HBM3, 700 W), most of it in the mLSTM's wk, wq and
    # w_up; the max is held to tests/test_torch_xlstm.py's 1 U (the JAX run
    # against itself from weights moved by one ulp spreads to 0.70 U), the
    # 99th percentile to 0.3 U, the median to the default 0.01 U
    _phase("xLSTM reference", 1, partial(phase_small_reference, bounds=(1.0, 0.3, 0.01)),
           XLSTM_SMALL, "xLSTM token-LM")
    # the LLM configs; each run's need is its reckoning rounded up (an upper
    # bound of what the cohort holds; activations come on top)
    for label, need in (("granite-3-2b + dcor", 71), ("yi-6b", 76), ("deepseek-moe-16b", 63)):
        err = _phase(f"{label} run", need, phase_llm_run, label)
        for name in k34_err:
            k34_err[name] = max(k34_err[name], err[name])
        k2_err = (max(k2_err[0], err["pairwise_dist_forward"]),
                  max(k2_err[1], err["pairwise_dist_backward"]))
    for arch in LLM_ARCHS:
        _phase(f"{arch} reference", 1, phase_llm_reference, arch, [])
    _phase("granite-3-2b dcor reference", 1, phase_llm_reference, "granite-3-2b",
           ["--dcor-alpha", "0.5"])
    _phase("population run", 11, phase_population_run)
    _phase("pairing loop run", 2, phase_pairing_loop_run)
    _phase("events run", 7, phase_events_run)
    _phase("population reference", 1, phase_small_reference,
           RESNET_SMALL + ["--codec", "topk0.05", "--exec", "chunked", "--chunk-size", "2",
                           "--population", "50", "--sample-size", "4"], "top-k population")
    _phase("pairing reference", 1, phase_small_reference,
           RESNET_SMALL + ["--topology", "pairing", "--exec", "loop", "--codec", "int8"],
           "pairing loop int8")
    _phase("chunked vs cohort", 1, phase_chunked_vs_cohort,
           RESNET_SMALL + ["--codec", "topk0.05"], "reduced resnet-56, top-k")
    # every client on tier 0: the card read a max of 0.000194 U (H100 80GB
    # HBM3, 700 W), one chunk width's matrix products against another's;
    # held to 0.001 U, below what one flipped top-k entry moves (up to 0.13 U)
    _phase("chunked vs cohort, tier 0", 1, phase_chunked_vs_cohort,
           RESNET_SMALL + ["--codec", "topk0.05", "--scheduler", "0"],
           "reduced resnet-56, top-k, every client on tier 0", 0.001)
    _phase("resume run", 7, phase_resume_run)
    _phase("async run", 7, phase_async_run)
    _phase("resume reference", 1, phase_resume_reference)
    _phase("async reference", 1, phase_small_reference,
           MICRO_SMALL + ["--engine", "async", "--n-groups", "3", "--rounds", "3", "--codec",
                          "int8"], "async int8")
    # a FedAvg round of 10 full-model clients holds what the int8 run's round
    # of 10 clients on tier 0 does (6.05 GiB allocated)
    _phase("baselines run", 8, phase_baselines_run, dtfl_clock)
    for method, extra in (("fedavg", ["--codec", "int8"]), ("tifl", []), ("fedgkt", []),
                          ("fedat", ["--engine", "async", "--codec", "int8"])):
        _phase(f"{method} reference", 1, phase_small_reference,
               RESNET_SMALL + ["--method", method] + extra, f"{method} {' '.join(extra)}".strip())
    entry["launches"] = k1_launches
    _phase("K1 device time", 1, phase_k1_device_time, entry)
    k2_fwd, k2_bwd = _phase("K2 times", 1, phase_k2_times, *k2_err)
    k2_fwd["launches"], k2_bwd["launches"] = k2_launches
    for name, err in K3_LAUNCHED_ERR.items():
        k34_err[name] = max(k34_err[name], err)
    k34 = _phase("K3/K4 times", 15, phase_k3_k4_times, k34_err)
    for e in k34:
        e["launches"] = k34_launches[e["name"]]
    k5 = _phase("K5 times", 3, phase_k5_times, k5_err)
    for e in k5:
        e["launches"] = k35_launches[e["name"]]
    _phase("K2 profile", 1, phase_k2_profile)
    _phase("dcor profile", 5, phase_rounds_profile, "dcor run", DCOR_PROFILE_ARGV,
           {"K2": K2_KERNELS})
    _phase("transformer profile", 60, phase_rounds_profile, "transformer run",
           TRANSFORMER_ARGV, {"K3": K3_KERNELS, "K4": K4_KERNELS})
    _phase("xLSTM profile", 72, phase_rounds_profile, "xLSTM run", XLSTM_ARGV,
           {"K5": MLSTM_KERNELS, "K3": K3_KERNELS})
    _phase("LLM times and MoE profile", 63, phase_llm_times_and_moe_profile)

    import torch

    print(f"[done] all phases in {time.perf_counter() - t0:.1f} s, "
          f"{_card_waited[0]:.1f} s of it waiting for the card")
    print(json.dumps({"kernels": [entry, k2_fwd, k2_bwd] + k34 + k5}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
